"""Source convenience classes: initialized components for common object
types.  Port of ``scarlet_tpu/models/source.py``.

The seeds are made on the host in numpy, as in the JAX package; the
symmetrization and the monotonic projection of
``SingleExtendedSource.init_morph`` run on the observations' device (K1
on the card).  Behavioral reference: scarlet/source.py.
"""
from __future__ import annotations

import logging
from functools import partial

import numpy as np
import torch

from .. import initialization as init
from ..ops import prox as prox_ops
from ..bbox import Box, overlapped_slices
from .component import Component, CombinedComponent, FactorizedComponent
from .constraint import CenterOnConstraint, PositivityConstraint
from .morphology import (
    ImageMorphology,
    PointSourceMorphology,
    ExtendedSourceMorphology,
    GaussianMorphology,
    SpergelMorphology,
    StarletMorphology,
)
from .parameter import Parameter, place, relative_step
from .renderer import torch_dtype
from .spectrum import TabulatedSpectrum

logger = logging.getLogger("scarlet_tpu_torch.source")

__all__ = [
    "NullSource",
    "RandomSource",
    "PointSource",
    "GaussianSource",
    "SpergelSource",
    "CompactExtendedSource",
    "SingleExtendedSource",
    "MultiExtendedSource",
    "StarletSource",
    "ExtendedSource",
]


def _mean_noise_rms(observations):
    out = []
    for obs in observations:
        rms = np.asarray(obs.noise_rms)
        rms = np.where(np.isfinite(rms), rms, np.nan)
        out.append(np.nanmean(rms, axis=(1, 2)))
    return np.concatenate(out).reshape(-1)


def _as_observations(observations):
    """Normalize a single Observation or an iterable to a tuple."""
    if hasattr(observations, "__iter__"):
        return tuple(observations)
    return (observations,)


def _center_param(model_frame, sky_coord, step=0.01):
    """The optimizable (y, x) center parameter every positional source
    carries (ref source.py uses steps 0.01-0.03 per class)."""
    return Parameter(model_frame.get_pixel(sky_coord), name="center",
                     step=step)


def _noise_floored_spectrum(model_frame, values, observations, scale=1.0):
    """TabulatedSpectrum whose minimum step is the mean per-band noise RMS
    (optionally rescaled by a profile peak value)."""
    rms = _mean_noise_rms(observations)
    return TabulatedSpectrum(model_frame, values / scale,
                             min_step=rms / scale)


def _box_at(center_index, shape):
    """A box of ``shape`` whose center pixel lands on ``center_index``."""
    origin = tuple(int(c) - n // 2 for c, n in zip(center_index, shape))
    return Box(tuple(shape), origin=origin)


def _peak(morphology):
    """The profile's value at its center (host float)."""
    return float(morphology.f(torch.zeros((), dtype=torch.float64)))


class NullSource(Component):
    """A source that contributes nothing. Ref: scarlet/source.py:24-58."""

    def __init__(self, model_frame):
        super().__init__(model_frame)

    def get_model(self, *parameters, frame=None):
        model = torch.zeros(self.frame.shape, dtype=torch.float64)
        if frame is not None:
            model = self.model_to_box(frame.bbox, model)
        return model


class RandomSource(FactorizedComponent):
    """Uniform-random seed source (numpy's global stream).
    Ref: scarlet/source.py:61-89."""

    def __init__(self, model_frame, observations=None):
        C, Ny, Nx = model_frame.bbox.shape
        image = np.random.rand(Ny, Nx)
        morphology = ImageMorphology(model_frame, image)
        spectrum = Parameter(
            np.random.rand(C), name="spectrum",
            step=partial(relative_step, factor=1e-1),
            constraint=PositivityConstraint(),
        )
        spectrum = TabulatedSpectrum(model_frame, spectrum)
        super().__init__(model_frame, spectrum, morphology)


class PointSource(FactorizedComponent):
    """PSF morphology + PSF-corrected peak-pixel spectrum.
    Ref: scarlet/source.py:92-128."""

    def __init__(self, model_frame, sky_coord, observations):
        observations = _as_observations(observations)
        morphology = PointSourceMorphology(
            model_frame, _center_param(model_frame, sky_coord, step=3e-2))
        spectrum = _noise_floored_spectrum(
            model_frame,
            init.get_pixel_spectrum(sky_coord, observations,
                                    correct_psf=True),
            observations)
        super().__init__(model_frame, spectrum, morphology)
        self.center = morphology.center


class GaussianSource(FactorizedComponent):
    """Gaussian profile + peak-pixel spectrum. Ref: scarlet/source.py:131-185."""

    def __init__(self, model_frame, sky_coord, sigma, ellipticity,
                 observations):
        observations = _as_observations(observations)
        sigma = Parameter(np.array((sigma,)), name="radius",
                          step=relative_step)
        if ellipticity is not None:
            ellipticity = Parameter(np.asarray(ellipticity),
                                    name="ellipticity", step=0.01)
        morphology = GaussianMorphology(
            model_frame, _center_param(model_frame, sky_coord), sigma,
            ellipticity=ellipticity)

        # the profile is peak-normalized by its central value, so the pixel
        # spectrum (and its noise floor) rescale by the same peak
        spectrum = _noise_floored_spectrum(
            model_frame,
            init.get_pixel_spectrum(sky_coord, observations,
                                    correct_psf=False),
            observations, scale=_peak(morphology))
        super().__init__(model_frame, spectrum, morphology)
        self.center = morphology.center


class SpergelSource(FactorizedComponent):
    """Spergel (2010) profile + peak-pixel spectrum.
    Ref: scarlet/source.py:188-246."""

    def __init__(self, model_frame, sky_coord, nu, rhalf, ellipticity,
                 observations):
        observations = _as_observations(observations)
        nu = Parameter(np.array((nu,), dtype=float), name="nu", step=0.01)
        rhalf = Parameter(np.array((rhalf,), dtype=float), name="radius",
                          step=partial(relative_step, factor=0.01))
        if ellipticity is not None:
            ellipticity = Parameter(np.asarray(ellipticity),
                                    name="ellipticity", step=0.01)
        morphology = SpergelMorphology(
            model_frame, _center_param(model_frame, sky_coord), nu, rhalf,
            ellipticity=ellipticity)

        spectrum = _noise_floored_spectrum(
            model_frame,
            init.get_pixel_spectrum(sky_coord, observations,
                                    correct_psf=False),
            observations, scale=_peak(morphology))
        super().__init__(model_frame, spectrum, morphology)
        self.center = morphology.center


class CompactExtendedSource(FactorizedComponent):
    """Point-source morphology seed with extended-source constraints.
    Ref: scarlet/source.py:249-364."""

    def __init__(self, model_frame, sky_coord, observations, shifting=False,
                 resizing=True, boxsize=None):
        observations = _as_observations(observations)
        assert model_frame.psf is not None
        morph, bbox = self.init_morph(model_frame, sky_coord, boxsize=boxsize)
        morphology = ExtendedSourceMorphology(
            model_frame, model_frame.get_pixel(sky_coord), morph, bbox=bbox,
            monotonic="angle", symmetric=False, min_grad=0,
            shifting=shifting, resizing=resizing,
        )

        # peak-pixel SED rescaled so spectrum x morph carries the peak flux
        spectrum = _noise_floored_spectrum(
            model_frame,
            init.get_pixel_spectrum(sky_coord, observations,
                                    correct_psf=True) / morph.sum(),
            observations)
        super().__init__(model_frame, spectrum, morphology)
        self.center = morphology.center

    @staticmethod
    def init_morph(frame, sky_coord, boxsize=None):
        """Point-source (frame PSF) morphology seed in a bucketed box.
        Ref: scarlet/source.py:315-364."""
        center_index = np.round(frame.get_pixel(sky_coord)).astype(int)
        psf_image = frame.psf.get_model().numpy().mean(axis=0)
        if boxsize is None:
            boxsize = init.get_minimal_boxsize(max(psf_image.shape))

        # paste the band-averaged PSF into the (possibly larger) seed box,
        # both centered on the source pixel
        bbox = _box_at(center_index, (boxsize, boxsize))
        morph = np.zeros(bbox.shape)
        dst, src = overlapped_slices(bbox, _box_at(center_index,
                                                   psf_image.shape))
        morph[dst] = psf_image[src]
        return morph / morph.max(), bbox


class SingleExtendedSource(FactorizedComponent):
    """SNR-coadd detection seed: SDSS-symmetrized, monotonic, thresholded,
    PSF-floored.  Ref: scarlet/source.py:367-522."""

    def __init__(self, model_frame, sky_coord, observations, thresh=1.0,
                 shifting=False, resizing=True, boxsize=None):
        observations = _as_observations(observations)
        spectra = init.get_pixel_spectrum(sky_coord, observations,
                                          concat=False)
        spectrum = _noise_floored_spectrum(
            model_frame, np.concatenate(spectra).reshape(-1), observations)

        image, std = init.build_initialization_image(observations,
                                                     spectra=spectra)
        morph, bbox = self.init_morph(
            model_frame, sky_coord, image, std, thresh=thresh, symmetric=True,
            monotonic="flat", min_grad=0, boxsize=boxsize,
            device=observations[0].device,
        )
        morphology = ExtendedSourceMorphology(
            model_frame, model_frame.get_pixel(sky_coord), morph, bbox=bbox,
            monotonic="angle", symmetric=False, min_grad=0,
            shifting=shifting, resizing=resizing,
        )
        super().__init__(model_frame, spectrum, morphology)
        self.center = morphology.center

    @staticmethod
    def init_morph(frame, sky_coord, detect, detect_std, thresh=1,
                   symmetric=True, monotonic="flat", min_grad=0, boxsize=None,
                   device="cpu"):
        """Symmetrized-monotonic morphology seed; the symmetrization and
        the projection run on ``device`` in the frame's precision (float32
        on a card), the rest on the host.  Ref: source.py:453-522."""
        center = frame.get_pixel(sky_coord)
        center_index = np.round(center).astype(int)

        im = place(np.array(detect, copy=True), device,
                   torch_dtype(frame.dtype))
        if symmetric:
            im = prox_ops.prox_uncentered_symmetry(
                im, 0, center=tuple(center_index), algorithm="sdss")
        if monotonic:
            if monotonic is True:
                monotonic = "angle"
            prox = prox_ops.build_prox_monotonic(
                tuple(im.shape), neighbor_weight=monotonic,
                center=tuple(center_index), min_gradient=min_grad)
            im = prox(im, 0)
        im = im.cpu().numpy()

        threshold = detect_std * thresh
        morph, bbox = init.trim_morphology(center_index, im,
                                           bg_thresh=threshold,
                                           boxsize=boxsize)

        if morph.sum() > 0:
            morph /= morph.max()
        else:
            logger.warning(
                f"No flux in morphology model for source at {sky_coord}")
            morph = CenterOnConstraint(tiny=1)(torch.from_numpy(morph),
                                               0).numpy()

        if frame.psf is not None:
            psf_morph, _ = CompactExtendedSource.init_morph(
                frame, sky_coord, boxsize=max(bbox.shape))
            morph = np.maximum(morph, psf_morph)
        return morph, bbox


class StarletSource(FactorizedComponent):
    """An extended-source seed (or, with ``sky_coord=None``, a full-frame
    :class:`RandomSource`, drawn from numpy's global stream) whose
    morphology becomes starlet coefficients in the same box.
    Ref: scarlet/source.py:525-612, scarlet_tpu/models/source.py:299-345.
    """

    def __init__(self, model_frame, sky_coord=None, observations=None,
                 spectrum=None, thresh=1.0, monotonic=False,
                 starlet_thresh=5e-3, boxsize=None):
        if sky_coord is None:
            source = RandomSource(model_frame)
        else:
            source = ExtendedSource(model_frame, sky_coord, observations,
                                    thresh=thresh, boxsize=boxsize)

        source = StarletSource.from_source(source, monotonic=monotonic,
                                           starlet_thresh=starlet_thresh)

        if spectrum is not None:
            if isinstance(spectrum, Parameter):
                assert spectrum.name == "spectrum"
                spectrum = TabulatedSpectrum(model_frame, spectrum)
            else:
                spectrum = TabulatedSpectrum(
                    model_frame, spectrum,
                    min_step=_mean_noise_rms(
                        _as_observations(observations)))
            children = list(source.children)
            children[0] = spectrum
            source._children = tuple(children)

        super().__init__(source.frame, *source.children)

    @classmethod
    def from_source(cls, source, monotonic=False, starlet_thresh=5e-3):
        """The factorized ``source`` with its morphology's model (host
        values) as starlet coefficients in the same box."""
        assert isinstance(source, FactorizedComponent)
        frame = source.frame
        spectrum, morphology = source.children
        morph = morphology.get_model().detach().cpu().numpy()
        morphology = StarletMorphology(frame, morph, bbox=morphology.bbox,
                                       monotonic=monotonic,
                                       threshold=starlet_thresh)
        obj = cls.__new__(cls)
        FactorizedComponent.__init__(obj, frame, spectrum, morphology)
        return obj


class MultiExtendedSource(CombinedComponent):
    """K components stacked by flux-percentile peeling of one extended
    seed.  Ref: scarlet/source.py:615-746."""

    def __init__(self, model_frame, sky_coord, observations, K=2,
                 flux_percentiles=None, thresh=1.0, shifting=False,
                 resizing=True, boxsize=None):
        if flux_percentiles is None:
            flux_percentiles = (25,)
        assert K == len(flux_percentiles) + 1
        observations = _as_observations(observations)

        source = ExtendedSource(model_frame, sky_coord, observations,
                                thresh=thresh, boxsize=boxsize)
        spectrum, morphology = source.children
        seed_sed = spectrum.get_parameter(0).numpy()
        morphs, boxes = self.init_morphs(morphology, flux_percentiles)

        center = model_frame.get_pixel(sky_coord)
        noise_rms = _mean_noise_rms(observations)
        components = []
        for morph_k, box_k in zip(morphs, boxes):
            morphology_k = ExtendedSourceMorphology(
                model_frame, center, morph_k, bbox=box_k,
                monotonic="angle", symmetric=False, min_grad=0,
                shifting=shifting, resizing=resizing,
            )
            self.center = morphology_k.center
            components.append(FactorizedComponent(
                model_frame,
                TabulatedSpectrum(model_frame, seed_sed.copy(),
                                  min_step=noise_rms / 10),
                morphology_k))
        super().__init__(components)

    @staticmethod
    def init_morphs(morphology, flux_percentiles):
        """Layer the seed morphology into flux shells: shell ``k`` holds the
        flux between consecutive percentile thresholds ``t_k < t_{k+1}`` of
        the peak value (ref source.py:713-746):
        shell_k = clip(morph - t_k, 0, t_{k+1} - t_k).
        """
        morph = morphology.get_model().detach().cpu().numpy()
        K = len(flux_percentiles) + 1

        cuts = np.sort(np.asarray(flux_percentiles, dtype=morph.dtype))
        bounds = np.concatenate(
            [[0.0], cuts * morph.max() / 100.0, [np.inf]])
        lo = bounds[:-1, None, None]
        shells = np.clip(morph[None] - lo, 0.0,
                         (bounds[1:, None, None] - lo)).astype(morph.dtype)

        for k, shell in enumerate(shells):
            if np.all(shell <= 0):
                logger.warning(
                    f"Zero or negative morphology for component {k}")
        shells /= np.maximum(shells.max(axis=(1, 2), keepdims=True), 1e-20)
        return shells, tuple(morphology.bbox.copy() for _ in range(K))


def ExtendedSource(model_frame, sky_coord, observations, K=1,
                   flux_percentiles=None, thresh=1.0, compact=False,
                   shifting=False, resizing=True, boxsize=None):
    """Factory: compact, single, or multi-component extended source.
    Ref: scarlet/source.py:757-807."""
    if compact:
        return CompactExtendedSource(
            model_frame, sky_coord, observations, shifting=shifting,
            resizing=resizing, boxsize=boxsize,
        )
    if K == 1:
        return SingleExtendedSource(
            model_frame, sky_coord, observations, thresh=thresh,
            shifting=shifting, resizing=resizing, boxsize=boxsize,
        )
    return MultiExtendedSource(
        model_frame, sky_coord, observations, K=K,
        flux_percentiles=flux_percentiles, thresh=thresh, shifting=shifting,
        resizing=resizing, boxsize=boxsize,
    )
