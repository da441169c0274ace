"""Source initialization: host-side (init-time) bootstrapping of spectra
and morphologies from data.  Port of ``scarlet_tpu/initialization.py``:
host numpy, as in the JAX package (the fallback ladder and the joint
least squares too); the observations' data, PSFs and renders are read
from their device.  Behavioral reference: scarlet/initialization.py.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .bbox import Box

logger = logging.getLogger("scarlet_tpu_torch.initialization")

__all__ = [
    "get_pixel_spectrum",
    "get_psf_spectrum",
    "get_minimal_boxsize",
    "trim_morphology",
    "build_initialization_image",
    "init_all_sources",
    "init_source",
    "set_spectra_to_match",
]


def _observation_tuple(observations):
    """Normalize a single Observation or an iterable to a tuple."""
    if hasattr(observations, "__iter__"):
        return tuple(observations)
    return (observations,)


def to_numpy(x):
    """A host numpy array of ``x`` (``lite.utils.to_numpy``, which this
    module cannot import: ``lite`` imports it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _data(obs):
    """The observation's data as host numpy, read once per data tensor."""
    hit = obs.__dict__.get("_data_host")
    if hit is None or hit[0] is not obs.data:
        hit = obs._data_host = (obs.data, to_numpy(obs.data))
    return hit[1]


def _warn_nonpositive(spectrum, sky_coord):
    """Log the reference's zero/negative-SED diagnostics (warning when the
    whole SED is bad, info when only some bands are)."""
    spectrum = np.asarray(spectrum)
    if (spectrum <= 0).any():
        msg = f"Zero or negative spectrum {spectrum} at {sky_coord}"
        (logger.warning if (spectrum <= 0).all() else logger.info)(msg)


def _pixel_index(obs, sky_coord):
    """Nearest observed pixel of a (possibly sky) coordinate."""
    return np.round(obs.get_pixel(sky_coord)).astype(int)


def get_pixel_spectrum(sky_coord, observations, correct_psf=False,
                       models=None, concat=True):
    """Spectrum of a unit-flux single-pixel source at ``sky_coord``,
    optionally PSF-peak-corrected, concatenated over observations.
    Ref: scarlet/initialization.py:12-85.
    """
    single = not hasattr(observations, "__iter__")
    observations = _observation_tuple(observations)
    if models is None:
        models = (None,) * len(observations)
    else:
        assert correct_psf is False
        # a lone observation takes its (single, possibly 3D-array) model
        # as-is; a list of observations takes a parallel list of models
        models = (models,) if single else tuple(models)
        assert len(models) == len(observations)

    spectra = []
    for obs, model in zip(observations, models):
        iy, ix = _pixel_index(obs, sky_coord)
        spectrum = np.array(_data(obs)[:, iy, ix], copy=True)

        if correct_psf and obs.psf is not None:
            # a point source of unit intensity registers at the PSF peak
            spectrum /= to_numpy(obs.psf.get_model()).max(axis=(1, 2))
        elif model is not None:
            spectrum /= to_numpy(model)[:, iy, ix]

        spectra.append(spectrum)
        _warn_nonpositive(spectrum, sky_coord)

    if concat:
        spectra = np.concatenate(spectra).reshape(-1)
    return spectra


def get_psf_spectrum(sky_coord, observations, compute_snr=False,
                     concat=True):
    """PSF-weighted (matched-filter) photometry at ``sky_coord``;
    optionally also its SNR.  Ref: scarlet/initialization.py:88-170.
    """
    observations = _observation_tuple(observations)

    spectra = []
    snr_num = snr_denom = 0.0
    for obs in observations:
        # PSF-sized cutouts of data and noise around the source pixel;
        # pixels off the observation or masked (non-finite rms) drop out
        # of the matched-filter sums via a zeroed PSF
        cutout_box = obs.psf.bbox + (0, *_pixel_index(obs, sky_coord))
        rms = np.asarray(obs.noise_rms)
        finite = np.isfinite(rms)
        valid = cutout_box.extract_from(finite.astype(float)) > 0
        img = np.where(valid, cutout_box.extract_from(_data(obs)),
                       0.0)
        noise = cutout_box.extract_from(np.where(finite, rms, 0.0))
        psf = np.where(valid, to_numpy(obs.psf.get_model()), 0.0)

        # matched filter per channel: flux = <img, psf> / <psf, psf>
        img_psf = np.sum(img * psf, axis=(1, 2))
        spectrum = img_psf / np.sum(psf * psf, axis=(1, 2))
        spectra.append(spectrum)
        _warn_nonpositive(spectrum, sky_coord)
        if compute_snr:
            snr_num = snr_num + img_psf.sum()
            snr_denom = snr_denom + np.sum(psf * noise ** 2 * psf)

    if concat:
        spectra = np.concatenate(spectra).reshape(-1)
    if compute_snr:
        return spectra, snr_num / np.sqrt(snr_denom)
    return spectra


def get_minimal_boxsize(size, min_size=21, increment=10):
    """Bucket a size into {21, 31, 41, ...}.
    Ref: scarlet/initialization.py:173-177."""
    steps = int(np.ceil(max(size - min_size, 0) / increment))
    return min_size + increment * steps


def trim_morphology(center_index, morph, bg_thresh=0, boxsize=None):
    """Zero sub-threshold pixels and cut a centered odd box around the
    remaining flux.  Ref: scarlet/initialization.py:180-210."""
    morph = np.where(np.asarray(morph) > bg_thresh, morph, 0)

    if boxsize is None:
        # smallest bucketed odd box, centered on the source, covering every
        # surviving pixel: twice the largest center-to-edge reach
        flux_box = Box.from_data(morph, min_value=0)
        cy, cx = center_index
        if flux_box.contains(center_index):
            reach = max(cy - flux_box.start[-2], flux_box.stop[-2] - cy,
                        cx - flux_box.start[-1], flux_box.stop[-1] - cx)
        else:
            reach = 0
        boxsize = get_minimal_boxsize(2 * reach)

    half = boxsize // 2
    bbox = Box.from_bounds(
        (center_index[0] - half, center_index[0] + half + 1),
        (center_index[1] - half, center_index[1] + half + 1))
    return bbox.extract_from(morph), bbox


def build_initialization_image(observations, spectra=None):
    """SNR-weighted detection coadd over same-grid observations, cached on
    observations[0] (host numpy).  Ref: scarlet/initialization.py:213-284.
    """
    from .models.renderer import NullRenderer, ConvolutionRenderer

    if not hasattr(observations, "__iter__"):
        observations = (observations,)
        spectra = (spectra,)
    assert len(observations) == len(spectra)

    model_frame = observations[0].model_frame

    def channel_selector(obs):
        """Which model channels this same-grid observation covers, or None
        for resampling renderers (excluded from the coadd)."""
        if not isinstance(obs.renderer, (NullRenderer, ConvolutionRenderer)):
            return None
        cmap = obs.renderer.channel_map
        return slice(None) if cmap is None else cmap

    # per-observation data/variance planes on the model grid, cached on the
    # first observation (many sources share one coadd)
    if not hasattr(observations[0], "_detect"):
        planes = []
        for obs in observations:
            cmap = channel_selector(obs)
            if cmap is None:
                continue
            data_slice, model_slice = obs.renderer.slices
            rms = np.where(np.isfinite(obs.noise_rms), obs.noise_rms, 0.0)
            d, v = (np.zeros(model_frame.shape, dtype=model_frame.dtype)
                    for _ in range(2))
            d[cmap][model_slice] += _data(obs)[data_slice]
            v[cmap][model_slice] += rms[data_slice] ** 2
            planes.append((d, v))
        observations[0]._detect = tuple(
            np.array(x) for x in zip(*planes))

    detect, var = observations[0]._detect

    # per-observation channel weights: the provided SED (or 1) on covered
    # channels, zero elsewhere
    seds = []
    for obs, sed in zip(observations, spectra):
        cmap = channel_selector(obs)
        if cmap is None:
            continue
        plane_sed = np.zeros(model_frame.C)
        plane_sed[cmap] = 1 if sed is None else sed
        seds.append(plane_sed)
    seds = np.asarray(seds)[:, :, None, None]

    with np.errstate(divide="ignore"):
        inv_var = np.where(var > 0, 1.0 / np.where(var > 0, var, 1.0), 0.0)
    weight = inv_var * seds
    return (weight * detect).sum(axis=(0, 1)), \
        np.sqrt((seds * weight).sum(axis=(0, 1)))


def init_all_sources(frame, centers, observations, thresh=1,
                     max_components=1, min_components=1, min_snr=50,
                     shifting=False, resizing=True, boxsize=None,
                     fallback=True, silent=False, set_spectra=True):
    """Initialize all sources, with the fallback ladder and the optional
    joint spectrum solve.  The seeds' projections and the solve's renders
    run on the observations' device.  Returns (sources, skipped indices).
    Ref: scarlet/initialization.py:287-363.
    """
    observations = _observation_tuple(observations)

    sources = []
    skipped = []
    for k, center in enumerate(centers):
        try:
            source = init_source(
                frame, center, observations, thresh=thresh,
                max_components=max_components, min_components=min_components,
                min_snr=min_snr, shifting=shifting, resizing=resizing,
                boxsize=boxsize, fallback=fallback,
            )
            sources.append(source)
        except Exception as e:
            logger.warning(f"Failed to initialize source {k}")
            if silent:
                skipped.append(k)
            else:
                raise e

    if set_spectra:
        set_spectra_to_match(sources, observations)
    return sources, skipped


def init_source(frame, center, observations, thresh=1, max_components=1,
                min_components=1, min_snr=50, shifting=False, resizing=True,
                boxsize=None, fallback=True):
    """Initialize one source, degrading the component count on failure
    (K -> ... -> compact).  Ref: scarlet/initialization.py:366-490.
    """
    from .models.source import ExtendedSource

    observations = _observation_tuple(observations)

    if fallback:
        # cap the component count by detection significance: one component
        # per min_snr units of PSF-photometry SNR, at least min_components
        _, psf_snr = get_psf_spectrum(center, observations, compute_snr=True)
        snr_cap = max(min_components, int(psf_snr // min_snr))
        max_components = min(int(max_components), snr_cap)

    while max_components >= 0:
        try:
            if max_components > 0:
                source = ExtendedSource(
                    frame, center, observations, thresh=thresh,
                    shifting=shifting, resizing=resizing, boxsize=boxsize,
                    K=max_components,
                )
            else:
                source = ExtendedSource(
                    frame, center, observations, shifting=shifting,
                    resizing=resizing, boxsize=boxsize, compact=True,
                )
            source.check_parameters()
        except ArithmeticError as e:
            if fallback:
                logger.info(
                    f"Could not initialize source at {center} with "
                    f"{max_components} components: {e}")
                max_components -= 1
                continue
            raise e
        return source


def set_spectra_to_match(sources, observations):
    """Joint weighted linear least-squares solve for all components'
    spectra given their rendered morphologies, with degenerate-model
    dedup (host numpy; the renders on the observations' device).
    Ref: scarlet/initialization.py:493-588.
    """
    from .models.component import FactorizedComponent, CombinedComponent
    from .models.parameter import place

    observations = _observation_tuple(observations)
    model_frame = observations[0].model_frame

    def flat_components(sources):
        for i, src in enumerate(sources):
            children = src.children if isinstance(src, CombinedComponent) \
                else (src,)
            for j, c in enumerate(children):
                yield i, j, c

    def spectrum_param(component):
        if not isinstance(component, FactorizedComponent):
            return None
        return next((q for q in component.parameters
                     if q.name == "spectrum"), None)

    # render each component at unit spectrum; components with numerically
    # identical unit models share one solve row (the dedup keeps the normal
    # matrix invertible)
    parameters, update_of, models = [], [], []
    for i, j, c in flat_components(sources):
        p = spectrum_param(c)
        parameters.append(p)
        if p is not None and not p.fixed:
            p.set(np.ones(p.shape))
        model = to_numpy(c.get_model(frame=model_frame))

        row = next((r for r, m in enumerate(models)
                    if np.allclose(model, m)), None)
        if row is None:
            update_of.append(len(models))
            models.append(model)
        else:
            update_of.append(row)
            logger.warning(
                f"Source {i}, Component {j} has a model identical to "
                "another component; spectra will be identical.")
    models = np.array(models)
    K_ = len(models)

    for obs in observations:
        images = _data(obs)
        weights = to_numpy(obs.weights)
        morphs = to_numpy(obs.render(place(models, obs.device))) if K_ else \
            np.zeros((0, obs.C) + images.shape[1:])
        spectra = np.zeros((K_, obs.C))
        for c in range(obs.C):
            im = images[c].reshape(-1)
            w = weights[c].reshape(-1)
            m = morphs[:, c].reshape(K_, -1)
            mw = m * w

            # exclude components whose flux lies mostly in zero-weight
            # pixels from this channel's solve (ref threshold: the weighted
            # flux fraction vs the mean weight must exceed 0.1)
            with np.errstate(invalid="ignore", divide="ignore"):
                coverage = mw.sum(axis=1) / m.sum(axis=1) / w.mean()
            keep = np.flatnonzero(coverage > 0.1)
            if keep.size:
                normal = mw[keep] @ m[keep].T
                spectra[keep, c] = np.linalg.inv(normal) @ (mw[keep] @ im)

        cmap = obs.renderer.channel_map
        if cmap is None:
            cmap = slice(None)
        for p, row in zip(parameters, update_of):
            if p is not None and not p.fixed:
                val = p.host().copy()
                val[cmap] = spectra[row]
                p.set(val)

    for p in parameters:
        if p is not None and p.constraint is not None:
            p.set(p.constraint(p.value, 0))
