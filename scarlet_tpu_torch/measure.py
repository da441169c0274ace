"""Post-fit measurements: flux, centroid, SNR, moments.  Port of
``scarlet_tpu/measure.py``.

Every function accepts a Component (with ``get_model``) or a raw
(C, H, W) array or tensor, and computes in host numpy: measurement
happens after the fit, off the hot path (the batched equivalents live in
:mod:`scarlet_tpu_torch.lite.measure`).  Behavioral reference:
scarlet/measure.py.
"""
from __future__ import annotations

import numpy as np

from .lite.utils import to_numpy

__all__ = ["max_pixel", "flux", "centroid", "snr", "moments"]


def _model_of(component):
    if hasattr(component, "get_model"):
        return to_numpy(component.get_model()), component.bbox.origin
    return to_numpy(component), 0


def max_pixel(component):
    """Location of the maximum-value pixel. Ref: measure.py:6-21."""
    model, origin = _model_of(component)
    return tuple(
        np.array(np.unravel_index(np.argmax(model), model.shape)) + origin
    )


def flux(component):
    """Per-channel flux. Ref: measure.py:24-37."""
    model, _ = _model_of(component)
    return model.sum(axis=(1, 2))


def centroid(component):
    """Intensity-weighted centroid. Ref: measure.py:40-57."""
    model, origin = _model_of(component)
    indices = np.indices(model.shape)
    cen = np.array([np.sum(ind * model) for ind in indices]) / model.sum()
    return cen + origin


def snr(component, observations):
    """Morphology-weighted SNR (Erben 2001 eq. 16, multi-band); the
    renders run on the observations' device.  Ref: measure.py:60-104.
    """
    from .models.parameter import place

    if not hasattr(observations, "__iter__"):
        observations = (observations,)

    if hasattr(component, "get_model"):
        frame = observations[0].model_frame
        model = to_numpy(component.get_model(frame=frame))
    else:
        model = to_numpy(component)

    M, W, var = [], [], []
    for obs in observations:
        model_ = to_numpy(obs.render(place(model, obs.device)))
        M.append(model_.reshape(-1))
        W.append(
            (model_ / (model_.sum(axis=(-2, -1))[:, None, None])).reshape(-1))
        rms = np.asarray(obs.noise_rms)
        noise_var = np.where(np.isfinite(rms), rms, 0.0) ** 2
        var.append(noise_var.reshape(-1))
    M = np.concatenate(M)
    W = np.concatenate(W)
    var = np.concatenate(var)
    return (M * W).sum() / np.sqrt(((var * W) * W).sum())


def moments(component, N=2, centroid=None, weight=None):
    """Image moments up to order N, keyed (power_y, power_x).
    Ref: measure.py:108-149.
    """
    model, _ = _model_of(component)
    if weight is None:
        weight = 1
    else:
        assert model.shape == np.asarray(weight).shape

    if centroid is None:
        centroid = np.array(model.shape) // 2

    grid_x, grid_y = np.indices(model.shape[-2:], dtype=np.float64)
    if model.ndim == 3:
        grid_y = grid_y[None, :, :]
        grid_x = grid_x[None, :, :]
    grid_y = grid_y - centroid[0]
    grid_x = grid_x - centroid[1]

    M = dict()
    for n in range(N + 1):
        for m in range(n + 1):
            M[m, n - m] = (
                grid_y ** m * grid_x ** (n - m) * model * weight
            ).sum(axis=(-2, -1))
    return M
