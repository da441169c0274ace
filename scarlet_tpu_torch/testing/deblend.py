"""Canonical deblending pipeline for regression runs
(scarlet_tpu/testing/deblend.py), on the object tree of this package.

Ref: scarlet/testing/deblend.py:9-93 — GaussianPSF(0.8) model frame,
``init_all_sources(max_components=2, min_snr=30)``, 100-iteration fit at
e_rel=1e-4, recording init time, runtime per source, iterations, and logL.
"""
from __future__ import annotations

import time

import numpy as np

from .. import initialization as init_mod
from ..models import Blend, Frame, GaussianPSF, ImagePSF, Observation
from . import settings

__all__ = ["deblend"]


def deblend(data, max_iter=None, e_rel=None, device=None):
    """Deblend one blend dict with keys images/variance/psfs/catalog
    (channel names from 'filters' if present) on ``device`` (default: the
    card; ``RuntimeError`` without one).  Returns (sources, blend,
    measurement record).
    """
    if max_iter is None:
        max_iter = settings.max_iter
    if e_rel is None:
        e_rel = settings.e_rel

    images = np.asarray(data["images"]).astype(np.float32)
    if "variance" in data:
        variance = np.asarray(data["variance"]).astype(np.float32)
    else:
        # simulated blends carry no variance plane: robust per-band estimate
        sigma = np.array([
            1.4826 * np.median(np.abs(im - np.median(im))) for im in images
        ])
        variance = np.ones_like(images) * (sigma ** 2)[:, None, None]
    psfs = np.asarray(data["psfs"]).astype(np.float32)
    catalog = data["catalog"]
    if "filters" in data:
        channels = [
            f.decode() if isinstance(f, bytes) else str(f)
            for f in np.asarray(data["filters"]).tolist()
        ]
    else:
        channels = list(settings.filters)[: images.shape[0]]

    weights = (1.0 / np.maximum(variance, 1e-12)).astype(np.float32)
    centers = [(float(row["y"]), float(row["x"])) for row in catalog]

    # The model-frame PSF must be narrower than every observed PSF for the
    # difference kernel to be well-posed.  The reference hardcodes sigma=0.8
    # (fine for real HSC seeing) — estimate the narrowest observed PSF width
    # and clamp below it so PSF-matched simulations also work.
    yy, xx = np.mgrid[0:psfs.shape[-2], 0:psfs.shape[-1]]
    cy, cx = psfs.shape[-2] // 2, psfs.shape[-1] // 2
    r2 = (yy - cy) ** 2 + (xx - cx) ** 2
    sigma_obs = np.sqrt(np.min([
        (p * r2).sum() / max(p.sum(), 1e-12) / 2 for p in psfs
    ]))
    sigma_model = float(np.clip(0.5 * sigma_obs, 0.3, 0.8))

    t0 = time.perf_counter()
    model_psf = GaussianPSF(sigma=sigma_model, boxsize=15)
    model_frame = Frame(images.shape, channels=channels, psf=model_psf)
    observation = Observation(images, channels, psf=ImagePSF(psfs),
                              weights=weights,
                              device=device).match(model_frame)
    sources, skipped = init_mod.init_all_sources(
        model_frame, centers, observation, max_components=2, min_snr=30,
        silent=True)
    init_time = time.perf_counter() - t0

    blend = Blend(sources, observation)
    t0 = time.perf_counter()
    n_iter, logL = blend.fit(max_iter, e_rel=e_rel)
    runtime = time.perf_counter() - t0

    record = {
        "init time": init_time * 1000,                      # ms
        "runtime": runtime / max(len(sources), 1) * 1000,   # ms per source
        "total runtime": runtime,                           # s
        "iterations": int(n_iter),
        "init logL": float(blend.log_likelihood[0]),
        "logL": float(logL),
        "skipped": skipped,
        "n_sources": len(sources),
        # the chosen model-frame PSF variance (px^2) — the shape metrics
        # compare moments in model-PSF-convolved space, so they need the
        # actual value, not a constant
        "model_psf_var": sigma_model ** 2,
    }
    return sources, blend, record
