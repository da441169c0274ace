"""Lite source initialization (host-side).

Behavioral reference: scarlet/lite/initialization.py.  Detection coadd,
monotonic morphology seeds (projected, or masked by the monotonic flood
fill), joint SED least squares, the SNR-gated 1/2-component bulge-disk
split of the scarlet-main recipe, and the wavelet recipe (starlet
detection dictionaries, bulge and disk from separate scales).
"""
from __future__ import annotations

import logging
from functools import partial

import numpy as np
import torch

from ..bbox import Box, overlapped_slices
from ..detect import bounds_to_bbox, get_detect_wavelets
from ..ops import prox as prox_ops
from ..initialization import trim_morphology
from ..models.parameter import relative_step
from .measure import calculate_snr
from .models import LiteSource, LiteFactorizedComponent, LiteComponent
from .parameters import AdaproxParameter, FistaParameter
from .utils import (insert_image, host_convolve as _host_convolve,
                    project_morph_to_center, to_numpy)

logger = logging.getLogger("scarlet_tpu_torch.lite.initialization")

__all__ = [
    "get_min_psf",
    "init_monotonic_morph",
    "multifit_seds",
    "init_main_parameters",
    "init_adaprox_component",
    "init_fista_component",
    "init_all_sources_main",
    "WaveletInitParameters",
    "init_wavelet_source",
    "init_all_sources_wavelets",
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


def get_min_psf(psfs, thresh=0.01):
    """Minimal centered cutout of the (C, h, w) ``psfs`` containing all
    cross-band PSF differences above ``thresh`` (host numpy).
    Ref: scarlet_tpu/lite/initialization.py:61-83."""
    psfs = to_numpy(psfs)
    py = psfs.shape[1] // 2
    px = psfs.shape[2] // 2
    X, Y = np.meshgrid(np.arange(psfs.shape[-1]), np.arange(psfs.shape[-2]))
    R = np.sqrt((X - px) ** 2 + (Y - py) ** 2)

    max_radius = 0
    for p1 in range(len(psfs) - 1):
        for p2 in range(p1 + 1, len(psfs)):
            diff = (psfs[p1] - psfs[p2]) / np.max([psfs[p1], psfs[p2]])
            significant = np.abs(diff) > thresh
            radius = int(np.max(R * significant))
            max_radius = max(max_radius, radius)

    dy = py - max_radius
    dx = px - max_radius
    sy = slice(dy, -dy) if dy > 0 else slice(None)
    sx = slice(dx, -dx) if dx > 0 else slice(None)
    return psfs[:, sy, sx].copy()


def init_monotonic_morph(detect, center, full_box, grow=0, normalize=True,
                         use_mask=True, thresh=0):
    """Monotonic morphology seed from a detection image.
    Ref: lite/initialization.py:83-137.

    ``use_mask=True``: the pixels reachable monotonically from the peak
    (:func:`prox_ops.prox_monotonic_mask`, no orphan interpolation), their
    bounds grown by ``grow`` and centered in the smallest quantized box.
    ``use_mask=False`` (the scarlet-main recipe): the detection image
    projected by the reference's sequential sweep in the host C library
    (:func:`prox_ops.prox_weighted_monotonic_seq`: one radius-ordered
    pass in float32, cast back to ``detect``'s dtype, as
    scarlet_tpu/lite/initialization.py:102-111 does; equal bit for bit to
    the Jacobi projection at ``monotonic_depth`` passes in float32) and
    trimmed at ``thresh``.  Returns (bbox, morph), morph None when the
    seed is empty.
    """
    detect = to_numpy(detect)
    if use_mask:
        _, morph, bounds = prox_ops.prox_monotonic_mask(detect, 0, center,
                                                        max_iter=0)
        bbox = bounds_to_bbox(bounds)
        if bbox.shape == (1, 1) and morph[bbox.slices][0, 0] == 0:
            return bbox, None
        if grow is not None and grow > 0:
            bbox = bbox.grow(grow)
        morph, bbox = project_morph_to_center(morph, center, bbox, full_box)
        if normalize:
            morph = morph / np.max(morph)
        return bbox, morph
    prox = prox_ops.prox_weighted_monotonic_seq(
        detect.shape, neighbor_weight="angle", min_gradient=0,
        center=center)
    morph = np.asarray(prox(detect, 0), dtype=detect.dtype)
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


def init_fista_component(center, bbox, sed, morph, observation,
                         bg_thresh=None):
    """Wrap seeds as a FISTA-optimized component: both factors step at
    ``1 / (2 mean(w))`` over the box's positive weights.
    Ref: lite/initialization.py:287-318."""
    slices = overlapped_slices(bbox, observation.bbox)
    w = to_numpy(observation.weights)[slices[1]]
    step = 2 * np.mean(w[w > 0])
    return LiteFactorizedComponent(
        FistaParameter(sed, step=1 / step), FistaParameter(morph,
                                                           step=1 / step),
        center, bbox, observation.bbox, to_numpy(observation.noise_rms),
        bg_thresh=bg_thresh,
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


class WaveletInitParameters:
    """Shared precomputations of the wavelet recipe: the starlet detection
    dictionaries (coefficients clipped at 0; detectlets = all detail
    scales, bulgelets = ``bulge_slice``, disklets = ``disk_slice``), the
    detectlets convolved to each band's seeing, and the PSF SED.
    Ref: lite/initialization.py:422-477."""

    def __init__(self, observation, bulge_slice=slice(None, 2),
                 disk_slice=slice(2, -1), bulge_grow=5, disk_grow=5,
                 use_psf=True, scales=5, wavelets=None):
        images = to_numpy(observation.images)
        if wavelets is None:
            wavelets = get_detect_wavelets(
                images, to_numpy(observation.variance), scales=scales)
        wavelets = np.array(to_numpy(wavelets), copy=True)
        wavelets[wavelets < 0] = 0
        detectlets = np.sum(wavelets[:-1], axis=0)
        bulgelets = np.sum(wavelets[bulge_slice], axis=0)
        disklets = np.sum(wavelets[disk_slice], axis=0)

        model_psf = to_numpy(observation.model_psf)
        convolved = _host_convolve(
            observation, np.repeat(detectlets[None, :, :],
                                   observation.shape[0], axis=0))
        convolved_psf = _host_convolve(
            observation, np.repeat(model_psf[0][None, :, :],
                                   images.shape[0], axis=0))
        py = model_psf.shape[1] // 2
        px = model_psf.shape[2] // 2

        self.observation = observation
        self.images = images
        self.convolved = convolved
        self.detectlets = detectlets
        self.bulgelets = bulgelets
        self.disklets = disklets
        self.bulge_grow = bulge_grow
        self.disk_grow = disk_grow
        self.psf_sed = convolved_psf[:, py, px]
        self.py = py
        self.px = px
        self.use_psf = use_psf


def init_wavelet_source(center, nbr_components, init):
    """One source from the wavelet dictionaries: the PSF seed below one
    component's S/N (or off the detectlets' support), one detectlets
    component below two, else a bulge and a disk with joint SEDs; a
    component whose SED solves to 0 is dropped, and a source whose seeds
    are all empty has no component.  Ref: lite/initialization.py:480-559.
    """
    observation = init.observation
    dtype = init.images.dtype
    model_psf = to_numpy(observation.model_psf)[0]
    sed_center = (slice(None), center[0], center[1])

    if (nbr_components < 1 and init.use_psf) or \
            init.detectlets[center[0], center[1]] <= 0:
        sed = _ratio_sed(init.images[sed_center], init.psf_sed)
        morph = model_psf / np.max(model_psf)
        bbox = Box(model_psf.shape,
                   origin=(center[0] - init.py, center[1] - init.px))
        component = LiteComponent(center, observation.bbox[0] @ bbox, sed,
                                  morph)
        return LiteSource([component], dtype)

    if nbr_components < 2:
        bbox, morph = init_monotonic_morph(
            init.detectlets, center, observation.bbox[1:], init.disk_grow)
        if morph is None or np.max(morph) <= 0:
            return LiteSource([], dtype)
        sed = _ratio_sed(init.images[sed_center],
                         init.convolved[sed_center])
        morph = morph / np.max(morph)
        component = LiteComponent(center, observation.bbox[0] @ bbox, sed,
                                  morph)
        return LiteSource([component], dtype)

    bulge_box, bulge_morph = init_monotonic_morph(
        init.bulgelets, center, observation.bbox[1:], init.bulge_grow)
    disk_box, disk_morph = init_monotonic_morph(
        init.disklets, center, observation.bbox[1:], init.disk_grow)

    if bulge_morph is None or disk_morph is None:
        if bulge_morph is None and disk_morph is None:
            return LiteSource([], dtype)
        return init_wavelet_source(center, 1, init)

    bulge_sed, disk_sed = multifit_seds(
        observation, [bulge_morph, disk_morph], [bulge_box, disk_box])

    components = []
    if np.sum(bulge_sed != 0):
        components.append(LiteComponent(
            center, observation.bbox[0] @ bulge_box, bulge_sed, bulge_morph))
    else:
        logger.debug("cut bulge")
    if np.sum(disk_sed) != 0:
        components.append(LiteComponent(
            center, observation.bbox[0] @ disk_box, disk_sed, disk_morph))
    else:
        logger.debug("cut disk")
    return LiteSource(components, dtype)


def init_all_sources_wavelets(observation, centers, min_snr=50, bulge_grow=5,
                              disk_grow=5, use_psf=True,
                              bulge_slice=slice(None, 2),
                              disk_slice=slice(2, -1), scales=5,
                              wavelets=None):
    """All sources from the wavelet dictionaries, each with its
    ``floor(snr) / min_snr`` components (:func:`init_wavelet_source`).
    Ref: lite/initialization.py:562-605."""
    init = WaveletInitParameters(
        observation, bulge_slice, disk_slice, bulge_grow, disk_grow, use_psf,
        scales, wavelets)
    variance = to_numpy(observation.variance)
    psfs = to_numpy(observation.psfs)
    sources = []
    for center in centers:
        snr = np.floor(calculate_snr(init.images, variance, psfs, center))
        sources.append(init_wavelet_source(center, snr / min_snr, init))
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
