"""Regression metrics (scarlet_tpu/testing/measure.py; ref:
scarlet/testing/measure.py, metric registry at 234-246, per-band
magnitude error vs truth at 62-76).  Models come to the host as numpy
(``to_numpy``) wherever they live."""
from __future__ import annotations

import numpy as np

from .. import measure as measure_mod
from ..lite.utils import to_numpy

__all__ = ["measurements", "mag_diff", "measure_lite_sources",
           "detection_metrics"]

# metric registry (name -> description); ref: testing/measure.py:234-246
measurements = {
    "init time": "Initialization time (ms per blend)",
    "runtime": "Fit runtime (ms per source)",
    "total runtime": "Total fit runtime (s per blend)",
    "iterations": "Iterations to convergence (cap 100)",
    "init logL": "log-likelihood after initialization",
    "logL": "final log-likelihood",
    "g diff": "magnitude error (g)",
    "r diff": "magnitude error (r)",
    "i diff": "magnitude error (i)",
    "z diff": "magnitude error (z)",
    "y diff": "magnitude error (y)",
    # beyond the reference's photometry-only set: astrometric recovery
    "pos diff": "centroid error vs truth position (px)",
    # shape recovery (model vs truth central 2nd moments, compared in
    # model-PSF-convolved space)
    "e1 diff": "ellipticity e1 error vs truth",
    "e2 diff": "ellipticity e2 error vs truth",
    "size diff": "relative rms-size error vs truth",
}


def detection_metrics(truth_yx, detected_yx, match_radius=3.0):
    """Detection quality vs a truth catalog: greedy nearest matching
    within ``match_radius`` px.

    Goes beyond the reference's photometry-only registry (the reference
    never scores its detection stage; detect_pybind11.cc has no tests) —
    completeness and false-positive rates are the standard survey
    detection metrics.

    Returns a dict with ``n_truth``, ``n_detected``, ``n_matched``,
    ``completeness`` (matched/truth), ``false_rate``
    (unmatched detections/detections), and ``match_dist`` (mean matched
    distance, px; NaN when nothing matched).
    """
    truth = np.asarray(truth_yx, float).reshape(-1, 2)
    det = np.asarray(detected_yx, float).reshape(-1, 2)
    nt, nd = len(truth), len(det)
    matched = 0
    dists = []
    if nt and nd:
        d = np.hypot(truth[:, None, 0] - det[None, :, 0],
                     truth[:, None, 1] - det[None, :, 1])
        while True:
            i, j = np.unravel_index(np.argmin(d), d.shape)
            if d[i, j] > match_radius:   # matched pairs are set to inf
                break
            dists.append(float(d[i, j]))
            matched += 1
            d[i, :] = np.inf
            d[:, j] = np.inf
    return {
        "n_truth": nt,
        "n_detected": nd,
        "n_matched": matched,
        "completeness": matched / nt if nt else 1.0,
        "false_rate": (nd - matched) / nd if nd else 0.0,
        "match_dist": float(np.mean(dists)) if dists else float("nan"),
    }


def mag_diff(truth_flux, model_flux, zero_point=27.0):
    """Per-band magnitude difference between truth and model fluxes.

    Ref: testing/measure.py:62-76.
    """
    truth_flux = np.maximum(np.asarray(truth_flux, float), 1e-12)
    model_flux = np.maximum(np.asarray(model_flux, float), 1e-12)
    m_true = zero_point - 2.5 * np.log10(truth_flux)
    m_model = zero_point - 2.5 * np.log10(model_flux)
    return m_model - m_true


def _truth_diff(rec, row, channels, flux):
    names = [f"intensity_{c}" for c in channels]
    if row is not None and all(n in (row.dtype.names or ()) for n in names):
        truth = np.array([row[n].sum() for n in names])
        # rows WITHOUT truth (all-zero/non-finite intensity images: the
        # real-sky sources of set 9, whose true flux is unknown) are
        # unscored for photometry, like the curated sets score only the
        # injected fake
        if not np.all(np.isfinite(truth)) or truth.sum() <= 0:
            return
        diff = mag_diff(truth, flux)
        for c, d in zip(channels, diff):
            rec[f"{c} diff"] = float(d)


def _truth_pos(rec, row, cen_yx):
    """Astrometric error vs the catalog position (px), when both exist."""
    if cen_yx is None or row is None:
        return
    names = row.dtype.names or ()
    if "y" not in names or "x" not in names:
        return
    cen_yx = np.asarray(cen_yx, float)
    if not np.all(np.isfinite(cen_yx)):
        return
    rec["pos diff"] = float(np.hypot(cen_yx[0] - float(row["y"]),
                                     cen_yx[1] - float(row["x"])))


def _central_moments(img):
    """(cy, cx, myy, mxx, mxy) flux-normalized central moments of a 2D
    image; None for an empty image."""
    img = np.asarray(img, np.float64)
    tot = img.sum()
    if tot <= 0:
        return None
    yy, xx = np.indices(img.shape, dtype=np.float64)
    cy = (yy * img).sum() / tot
    cx = (xx * img).sum() / tot
    return (cy, cx,
            (((yy - cy) ** 2) * img).sum() / tot,
            (((xx - cx) ** 2) * img).sum() / tot,
            ((yy - cy) * (xx - cx) * img).sum() / tot)


def _ellipticity(myy, mxx, mxy):
    tr = myy + mxx
    if tr <= 0:
        return None
    return (mxx - myy) / tr, 2.0 * mxy / tr, np.sqrt(tr)


def _truth_shape(rec, row, channels, moments, psf_var):
    """Shape-recovery metrics: model vs truth central 2nd moments of the
    channel-summed source, compared in model-PSF-convolved space (the
    truth intensity images are unconvolved, so the model PSF's variance
    is added to the truth's diagonal moments).

    ``moments`` is the model's (myy, mxx, mxy); ``psf_var`` the model
    PSF variance in px^2 (sigma^2).
    """
    if moments is None or row is None:
        return
    moments = np.asarray(moments, float)
    if not np.all(np.isfinite(moments)):
        return
    names = [f"intensity_{c}" for c in channels]
    if not all(n in (row.dtype.names or ()) for n in names):
        return
    truth_img = np.sum([row[n] for n in names], axis=0)
    t = _central_moments(truth_img)
    if t is None:
        return
    e_t = _ellipticity(t[2] + psf_var, t[3] + psf_var, t[4])
    e_m = _ellipticity(*moments)
    if e_t is None or e_m is None:
        return
    rec["e1 diff"] = float(e_m[0] - e_t[0])
    rec["e2 diff"] = float(e_m[1] - e_t[1])
    rec["size diff"] = float((e_m[2] - e_t[2]) / e_t[2])


def _model_centroid(src):
    """(y, x) scene centroid of a source's model, or None for an empty
    model (measure.centroid divides by the total).  Assembles the model
    once and adds the box origin itself."""
    model = to_numpy(src.get_model())
    if not np.any(model > 0):
        return None
    cen = np.asarray(measure_mod.centroid(model))[-2:]
    return cen + np.asarray(src.bbox.origin)[-2:]


def _source_model_moments(src):
    """(myy, mxx, mxy) of a source's channel-summed model, or None."""
    img = to_numpy(src.get_model()).sum(axis=0)
    m = _central_moments(img)
    return None if m is None else m[2:]


def measure_lite_sources(sources, catalog, channels, psf_var=0.64):
    """Per-source flux (redistributed ``weight_sources`` flux when present,
    model flux otherwise), centroid, and per-band magnitude / position /
    shape error vs catalog truth."""
    records = []
    for src, row in zip(sources, catalog):
        if getattr(src, "flux", None) is not None:
            flux = to_numpy(src.flux).sum(axis=(-2, -1))
        else:
            flux = to_numpy(src.get_model()).sum(axis=(-2, -1))
        rec = {"flux": flux.tolist()}
        _truth_diff(rec, row, channels, flux)
        _truth_pos(rec, row, _model_centroid(src))
        _truth_shape(rec, row, channels, _source_model_moments(src),
                     psf_var)
        records.append(rec)
    return records


def measure_flux_records(fluxes, catalog, channels, centroids=None,
                         moments=None, psf_var=0.64):
    """Per-source flux + per-band magnitude error from raw (K, C) flux
    arrays (the device stream path's measurement output); with
    ``centroids`` (K, 2 per blend, scene coords) also the position
    error, and with ``moments`` (K, 3 central 2nd moments) the shape
    errors."""
    records = []
    if centroids is None:
        centroids = [None] * len(catalog)
    if moments is None:
        moments = [None] * len(catalog)
    for flux, row, cen, mom in zip(fluxes, catalog, centroids, moments):
        flux = np.asarray(flux)
        rec = {"flux": flux.tolist()}
        _truth_diff(rec, row, channels, flux)
        _truth_pos(rec, row, cen)
        _truth_shape(rec, row, channels, mom, psf_var)
        records.append(rec)
    return records


def measure_sources(sources, catalog, channels, psf_var=0.64):
    """Per-source flux, centroid, and per-band magnitude / position /
    shape error vs catalog truth (when the catalog carries
    intensity_<band> truth images)."""
    records = []
    for src, row in zip(sources, catalog):
        flux = to_numpy(measure_mod.flux(src))
        rec = {"flux": flux.tolist()}
        _truth_diff(rec, row, channels, flux)
        _truth_pos(rec, row, _model_centroid(src))
        _truth_shape(rec, row, channels, _source_model_moments(src),
                     psf_var)
        records.append(rec)
    return records
