"""Lite source initialization (host-side).

Behavioral reference: scarlet/lite/initialization.py.  Detection coadd,
monotonic morphology seeds, joint SED least squares, and the SNR-gated
1/2-component bulge-disk split of the scarlet-main recipe.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..bbox import Box
from ..ops import prox as prox_ops
from ..initialization import trim_morphology
from ..models.parameter import relative_step
from .measure import calculate_snr
from .models import LiteSource, LiteFactorizedComponent, LiteComponent
from .parameters import AdaproxParameter
from .utils import insert_image, host_convolve as _host_convolve, to_numpy

__all__ = [
    "init_monotonic_morph",
    "multifit_seds",
    "init_main_parameters",
    "init_adaprox_component",
    "init_all_sources_main",
    "parameterize_sources",
]


def _ratio_sed(num, den):
    """Peak-ratio SED ``images/convolved``; bands with a zero, negative or
    non-finite denominator carry no usable ratio and seed 0 (the fit's
    gradient recovers them).  Equal to the reference's plain ratio wherever
    the denominator is positive and finite."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = num / den
    sed = np.where((den > 0) & np.isfinite(ratio), ratio, 0.0)
    sed[sed < 0] = 0
    return sed.astype(num.dtype, copy=False)


def init_monotonic_morph(detect, center, full_box, grow=0, normalize=True,
                         use_mask=True, thresh=0):
    """Monotonic morphology seed from a detection image.
    Ref: lite/initialization.py:83-137.

    Only ``use_mask=False`` (the scarlet-main recipe) is ported: the
    detection image is projected with the exact Jacobi formulation at
    ``n_iter = monotonic_depth`` (equal to the reference's sequential
    sweep) and trimmed at ``thresh``.
    """
    if use_mask:
        raise NotImplementedError(
            "init_monotonic_morph(use_mask=True) is not ported")
    detect = to_numpy(detect)
    weights = prox_ops.monotonic_weights(detect.shape, "angle", center)
    n_iter = prox_ops.monotonic_depth(weights, detect.shape, center)
    morph = to_numpy(prox_ops.prox_weighted_monotonic(
        torch.from_numpy(np.ascontiguousarray(detect)), weights, n_iter,
        min_gradient=0, center=center))
    morph, bbox = trim_morphology(center, morph, bg_thresh=thresh)
    if np.max(morph) == 0:
        return Box((0, 0, 0)), None
    if normalize:
        morph = morph / np.max(morph)
    return bbox, morph


def multifit_seds(observation, morphs, boxes):
    """Joint per-band linear least squares for several components' SEDs.
    Ref: lite/initialization.py:140-185."""
    if len(morphs) != len(boxes):
        raise ValueError(
            f"morphs and boxes must be the same length, got {len(morphs)} "
            f"and {len(boxes)}")
    images = to_numpy(observation.images)
    bands = images.shape[0]
    dtype = images.dtype

    spec_box = observation.bbox[0]
    full_box = boxes[0]
    for box in boxes[1:]:
        full_box = full_box | box
    full_box = spec_box @ full_box
    img = insert_image(full_box, observation.bbox, images)

    morph_images = np.zeros((bands, len(morphs), img[0].size), dtype=dtype)
    for idx, (morph, bbox) in enumerate(zip(morphs, boxes)):
        _img = insert_image(full_box, spec_box @ bbox,
                            to_numpy(morph)[None, :, :])
        convolved = _host_convolve(observation, _img)
        morph_images[:, idx] = convolved.reshape(bands, -1)

    seds = np.zeros((len(morphs), bands), dtype=dtype)
    for b in range(bands):
        A = np.vstack(morph_images[b]).T
        seds[:, b] = np.linalg.lstsq(A, img[b].flatten(), rcond=None)[0]
    seds[seds < 0] = 0
    return seds


def init_main_parameters(detect, center, observation, convolved=None,
                         use_mask=False, thresh=0.5):
    """Seed (bbox, morph, sed) the way scarlet main does: SDSS-symmetrized
    detection image, monotonic projection, threshold trim, SED from the
    image/convolved ratio at the peak.  Ref: lite/initialization.py:188-247.
    """
    _detect = to_numpy(prox_ops.prox_uncentered_symmetry(
        torch.from_numpy(np.array(to_numpy(detect), copy=True)), 0, center,
        "sdss"))
    thresh = float(np.mean(to_numpy(observation.noise_rms))) * thresh

    bbox, morph = init_monotonic_morph(
        _detect, center, observation.bbox[1:], grow=0, normalize=False,
        use_mask=use_mask, thresh=thresh,
    )
    if morph is None:
        return bbox, None, None

    sed_center = (slice(None), center[0], center[1])
    images = to_numpy(observation.images)

    if convolved is None:
        _morph = insert_image(observation.bbox[1:], bbox, morph)
        convolved = _host_convolve(
            observation, np.repeat(_morph[None, :, :], images.shape[0],
                                   axis=0))
    convolved = to_numpy(convolved)
    sed = _ratio_sed(images[sed_center], convolved[sed_center])
    morph_max = np.max(morph)
    sed = sed * morph_max
    morph = morph / morph_max
    return bbox, morph, sed


def init_adaprox_component(center, bbox, sed, morph, observation, factor=10,
                           bg_thresh=None, max_prox_iter=1):
    """Wrap seeds as an adaprox-optimized component.
    Ref: lite/initialization.py:250-284."""
    noise_rms = to_numpy(observation.noise_rms)
    sed = AdaproxParameter(
        sed,
        step=partial(relative_step, factor=1e-2, minimum=noise_rms / factor),
        max_prox_iter=max_prox_iter,
    )
    morph = AdaproxParameter(morph, step=1e-2, max_prox_iter=max_prox_iter)
    return LiteFactorizedComponent(
        sed, morph, center, bbox, observation.bbox,
        to_numpy(observation.noise_rms), bg_thresh=bg_thresh,
    )


def init_all_sources_main(observation, centers, detect=None, min_snr=50,
                          use_mask=False, percentile=25, thresh=0.5):
    """Initialize all sources with the scarlet-main recipe: chi^2 coadd
    detection image, SNR-gated 1- or 2-component (bulge/disk)
    factorization, PSF fallback.  Ref: lite/initialization.py:321-419."""
    images = to_numpy(observation.images)
    noise_rms = to_numpy(observation.noise_rms)
    if detect is None:
        detect = np.sum(images / (noise_rms ** 2)[:, None, None], axis=0)
    convolved = _host_convolve(
        observation, np.repeat(detect[None, :, :], observation.shape[0],
                               axis=0))
    model_psf = to_numpy(observation.model_psf)
    convolved_psf = _host_convolve(
        observation, np.repeat(model_psf, images.shape[0], axis=0))
    model_psf = model_psf[0]
    py = model_psf.shape[0] // 2
    px = model_psf.shape[1] // 2
    psf_sed = convolved_psf[:, py, px]

    variance = to_numpy(observation.variance)
    psfs = to_numpy(observation.psfs)
    sources = []
    for center in centers:
        snr = np.floor(calculate_snr(images, variance, psfs, center))
        component_snr = snr / min_snr

        bbox, morph, sed = init_main_parameters(
            detect, center, observation, convolved, use_mask, thresh)

        if morph is None:
            sed_center = (slice(None), center[0], center[1])
            sed = _ratio_sed(images[sed_center], psf_sed)
            morph = model_psf / np.max(model_psf)
            bbox = Box(model_psf.shape,
                       origin=(center[0] - py, center[1] - px))
            components = [LiteComponent(center, observation.bbox[0] @ bbox,
                                        sed, morph)]
        elif component_snr >= 2:
            bulge_morph = morph.copy()
            disk_morph = morph.copy()
            flux_thresh = percentile / 100
            disk_morph[disk_morph > flux_thresh] = flux_thresh
            bulge_morph -= flux_thresh
            bulge_morph[bulge_morph < 0] = 0

            if np.max(bulge_morph) == 0 or np.max(disk_morph) == 0:
                components = [LiteComponent(center,
                                            observation.bbox[0] @ bbox,
                                            sed, morph)]
            else:
                bulge_morph /= np.max(bulge_morph)
                disk_morph /= np.max(disk_morph)
                bulge_sed, disk_sed = multifit_seds(
                    observation, [bulge_morph, disk_morph], [bbox, bbox])
                components = [
                    LiteComponent(center, observation.bbox[0] @ bbox,
                                  bulge_sed, bulge_morph),
                    LiteComponent(center, observation.bbox[0] @ bbox,
                                  disk_sed, disk_morph),
                ]
        else:
            components = [LiteComponent(center, observation.bbox[0] @ bbox,
                                        sed, morph)]

        sources.append(LiteSource(components, images.dtype))
    return sources


def parameterize_sources(sources, observation, parameterization):
    """Wrap raw (sed, morph) seeds into optimizer parameters.
    Ref: lite/initialization.py:608-645."""
    new_sources = []
    for src in sources:
        components = []
        for c in src.components:
            component = parameterization(
                center=tuple(coord for coord in c.center),
                sed=np.array(to_numpy(c.sed), copy=True),
                morph=np.array(to_numpy(c.morph), copy=True),
                bbox=c.bbox.copy(),
                observation=observation,
            )
            components.append(component)
        new_sources.append(LiteSource(components, src.dtype))
    return new_sources
