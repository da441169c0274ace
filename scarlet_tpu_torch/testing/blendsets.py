"""Generated blends: HSC-like 5-band scenes with injected point sources
and extended (Gaussian, exponential or Spergel-profile) galaxies,
per-band seeing, Gaussian noise and a truth catalog carrying per-band
``intensity_<band>`` images.  Numpy only, so tests and ``chip_smoke.py``
need no dataset.  Port of ``scarlet_tpu/testing/blendsets.py``
``generate_blend``: the same ``rng`` stream gives the same blend, bit for
bit.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve

__all__ = ["FILTERS", "generate_blend"]

# HSC bands (scarlet/testing/settings.py)
FILTERS = "grizy"


def _gaussian_psf(sigma, size=21, e=0.0, angle=0.0):
    """Gaussian PSF, optionally elliptical: axis ratio ``1-e`` at
    position angle ``angle`` (real per-band seeing is anisotropic —
    the curated HSC sets' PSFs are; the reference's simulated
    psf_matched_sim.npz uses round Gaussians)."""
    yy, xx = np.mgrid[:size, :size] - (size - 1) / 2.0
    c, s = np.cos(angle), np.sin(angle)
    u = c * xx + s * yy
    v = -s * xx + c * yy
    q = max(1.0 - e, 0.3)
    p = np.exp(-(u ** 2 / q + v ** 2 * q) / (2 * sigma ** 2))
    return (p / p.sum()).astype(np.float32)


def _spergel_nu(r, nu):
    """Unit-peak Spergel (2010) radial profile ``(r)^nu K_nu(r)`` in
    scaled radius; nu in [-0.85, 4] spans the Sersic n ~ 4 .. 0.5 range
    (nu=0.5 is exactly exponential), rendered with scipy's kv."""
    from scipy.special import kv, gamma

    r = np.maximum(r, 1e-8)
    f = r ** nu * kv(nu, r)
    # finite central value: lim_{r->0} r^nu K_nu(r) = gamma(nu) 2^(nu-1)
    peak = gamma(nu) * 2 ** (nu - 1) if nu > 0 else f.max()
    return (f / peak).astype(np.float32)


def _profile(kind, radius, q, angle, size):
    """Unit-peak elliptical radial profile on a (size, size) grid."""
    yy, xx = np.mgrid[:size, :size] - (size - 1) / 2.0
    c, s = np.cos(angle), np.sin(angle)
    u = (c * xx + s * yy) / max(q, 0.2)
    v = -s * xx + c * yy
    r = np.sqrt(u ** 2 + v ** 2) / max(radius, 0.3)
    if kind == "exp":
        return np.exp(-1.67835 * r)
    return np.exp(-0.5 * r ** 2)


def generate_blend(rng, shape=(5, 58, 48), n_sources=None, min_sep=5.0,
                   noise_sigma=0.1, spergel_frac=0.0, psf_ellip=0.0,
                   noise_corr=0.0):
    """One synthetic blend dict: images/variance/psfs/filters/catalog with
    full-scene truth-intensity images per source.

    Realism knobs (the curated HSC-COSMOS material has all three,
    docs/regression.rst:4-12 of the reference):

    * ``spergel_frac``: fraction of galaxies drawn with Spergel(2010)
      profiles (nu in [-0.6, 1.5] ~ Sersic n 4 .. 0.5) instead of
      Gaussian/exponential;
    * ``psf_ellip``: per-band PSF ellipticity drawn in [0, psf_ellip]
      at a random angle;
    * ``noise_corr``: Gaussian correlation length (px) of the pixel
      noise (coadd resampling correlates real survey noise; the
      variance plane still records the MARGINAL per-pixel variance, so
      the fit's independence assumption is stressed exactly like on
      real coadds).
    """
    C, H, W = shape
    filters = list(FILTERS)[:C]
    sigmas = rng.uniform(1.1, 2.1, size=C).astype(np.float32)
    # knob-gated draws must not consume the rng stream when off, so a
    # seed gives the same blend with the knobs at 0
    if psf_ellip > 0:
        ells = rng.uniform(0.0, psf_ellip, size=C)
        pangs = rng.uniform(0, np.pi, size=C)
    else:
        ells = np.zeros(C)
        pangs = np.zeros(C)
    psfs = np.stack([_gaussian_psf(s, 21, e, a)
                     for s, e, a in zip(sigmas, ells, pangs)])

    if n_sources is None:
        n_sources = int(rng.integers(3, 11))

    # blended but resolvable positions: rejection-sample a minimum
    # separation
    centers = []
    for _ in range(200):
        if len(centers) >= n_sources:
            break
        y = rng.uniform(6, H - 7)
        x = rng.uniform(6, W - 7)
        if all((y - cy) ** 2 + (x - cx) ** 2 >= min_sep ** 2
               for cy, cx in centers):
            centers.append((y, x))
    n_sources = len(centers)

    dtype = [("index", "<i8"), ("x", "<f8"), ("y", "<f8"), ("is_star", "?"),
             ("radius", "<f8"), ("sed", "<f8", (C,))]
    dtype += [(f"intensity_{f}", "<f4", (H, W)) for f in filters]
    catalog = np.zeros(n_sources, dtype=dtype)

    scene_truth = np.zeros((C, H, W), np.float32)
    for i, (y, x) in enumerate(centers):
        is_star = rng.random() < 0.3
        # smooth random SED: log-uniform band weights, unit sum
        sed = rng.dirichlet(np.full(C, 2.0)).astype(np.float64)
        # HSC-like peak SNR range (tens to a few hundred)
        flux = 10 ** rng.uniform(1.0, 2.7)   # total counts
        if is_star:
            radius = 0.0
            img = np.zeros((H, W), np.float32)
            iy, ix = int(round(y)), int(round(x))
            img[iy, ix] = 1.0
        else:
            radius = float(rng.uniform(1.0, 4.0))
            q = float(rng.uniform(0.4, 1.0))
            angle = float(rng.uniform(0, np.pi))
            spergel = spergel_frac > 0 and rng.random() < spergel_frac
            kind = "exp" if rng.random() < 0.6 else "gauss"
            size = min(2 * int(4 * radius) + 21, 2 * min(H, W) - 1)
            if spergel:
                nu = float(rng.uniform(-0.6, 1.5))
                yy, xx = np.mgrid[:size, :size] - (size - 1) / 2.0
                c, s = np.cos(angle), np.sin(angle)
                u = (c * xx + s * yy) / max(q, 0.2)
                v = -s * xx + c * yy
                r = np.sqrt(u ** 2 + v ** 2) / max(radius, 0.3)
                prof = _spergel_nu(r, nu)
            else:
                prof = _profile(kind, radius, q, angle,
                                size).astype(np.float32)
            img = np.zeros((H, W), np.float32)
            iy, ix = int(round(y)), int(round(x))
            h = size // 2
            ys, xs = slice(max(0, iy - h), min(H, iy + h + 1)), \
                slice(max(0, ix - h), min(W, ix + h + 1))
            pys = slice(ys.start - (iy - h), size - ((iy + h + 1) - ys.stop))
            pxs = slice(xs.start - (ix - h), size - ((ix + h + 1) - xs.stop))
            img[ys, xs] = prof[pys, pxs]
        img = img / max(img.sum(), 1e-12) * flux
        truth = (sed[:, None, None] * img[None]).astype(np.float32)
        scene_truth += truth

        catalog[i]["index"] = i
        catalog[i]["y"] = y
        catalog[i]["x"] = x
        catalog[i]["is_star"] = is_star
        catalog[i]["radius"] = radius
        catalog[i]["sed"] = sed
        for b, f in enumerate(filters):
            catalog[i][f"intensity_{f}"] = truth[b]

    images = np.stack([
        fftconvolve(scene_truth[b], psfs[b], mode="same")
        for b in range(C)
    ]).astype(np.float32)
    sigma_b = (noise_sigma * (1.0 + rng.uniform(-0.3, 0.3, size=C))
               ).astype(np.float32)
    noise = rng.standard_normal(images.shape).astype(np.float32)
    if noise_corr > 0:
        # correlate, then rescale so sigma_b stays the MARGINAL per-pixel
        # std (the quantity the variance plane records on real coadds)
        k = _gaussian_psf(noise_corr, 2 * int(3 * noise_corr) + 1)
        noise = np.stack([fftconvolve(n, k, mode="same") for n in noise])
        noise /= np.sqrt(np.sum(k.astype(np.float64) ** 2)).astype(
            np.float32)
    images += noise * sigma_b[:, None, None]
    variance = np.broadcast_to((sigma_b ** 2)[:, None, None],
                               images.shape).copy()

    return {
        "images": images,
        "variance": variance,
        "psfs": psfs,
        "filters": np.asarray(filters),
        "catalog": catalog,
    }
