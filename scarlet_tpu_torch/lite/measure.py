"""Lite measurements (host-side numpy).  Behavioral reference:
scarlet/lite/measure.py."""
from __future__ import annotations

import numpy as np

from ..bbox import Box, overlapped_slices
from .utils import insert_image, host_convolve, to_numpy

__all__ = ["calculate_snr", "weight_sources"]


def calculate_snr(images, variance, psfs, center):
    """PSF-weighted signal-to-noise at ``center``.
    Ref: scarlet/lite/measure.py:7-36."""
    images = to_numpy(images)
    variance = to_numpy(variance)
    psfs = to_numpy(psfs)
    py = psfs.shape[1] // 2
    px = psfs.shape[2] // 2
    bbox = Box(psfs.shape, origin=(0, -py + center[0], -px + center[1]))
    noise = bbox.extract_from(variance)
    img = bbox.extract_from(images)
    numerator = img * psfs
    denominator = (psfs * noise) * psfs
    return np.sum(numerator) / np.sqrt(np.sum(denominator))


def weight_sources(blend, mask_footprint=True):
    """Redistribute observed flux among sources by their model ratios; sets
    ``src.flux``/``src.flux_box``.  Ref: scarlet/lite/measure.py:39-91."""
    observation = blend.observation
    py = observation.psfs.shape[-2] // 2
    px = observation.psfs.shape[-1] // 2

    images = to_numpy(observation.images).copy()
    if mask_footprint:
        images = images * (to_numpy(observation.weights) > 0)
    model = blend.get_model()
    model = np.array(host_convolve(observation, model))
    model[model < 0] = 0

    for src in blend.sources:
        if len(src.components) == 0:
            src.flux = 0
            src.flux_box = Box((0, 0, 0))
            continue
        _model = src.get_model()
        bbox = src.bbox.grow((0, py, px))
        _model = insert_image(bbox, src.bbox, _model)
        _model = np.array(host_convolve(observation, _model))
        _model[_model < 0] = 0
        slices = overlapped_slices(observation.bbox, bbox)
        numerator = _model[slices[1]]
        denominator = model[slices[0]]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = numerator / denominator
        ratio[denominator == 0] = 0
        ratio[ratio > 1] = 1
        src.flux = ratio * images[slices[0]]
        src.flux_box = observation.bbox & bbox
