"""Generated blends: HSC-like 5-band scenes with injected point sources
and extended (Gaussian, exponential or Spergel-profile) galaxies,
per-band seeing, Gaussian noise and a truth catalog carrying per-band
``intensity_<band>`` images.  Numpy only, so tests and ``chip_smoke.py``
need no dataset.  Port of ``scarlet_tpu/testing/blendsets.py``: the same
``rng`` stream gives the same blend, bit for bit.

:func:`generate_blend_set` writes the synthetic regression sets 4-8 as
npz files; :func:`generate_real_blend_set` (set 9) injects one fake
source into crops of the reference's two real HSC-COSMOS cutouts
(``hsc_cosmos_35.npz`` and ``hsc_cosmos.npz`` of its ``data/``
directory), which it reads from ``data_dir`` and never fetches.
"""
from __future__ import annotations

import pathlib

import numpy as np

__all__ = ["FILTERS", "default_root", "generate_blend",
           "generate_blend_set", "generate_real_blend",
           "generate_real_blend_set"]

# HSC bands (scarlet/testing/settings.py)
FILTERS = "grizy"


def default_root():
    """The regression store's root, ``.regression`` under the working
    directory (scarlet_tpu/testing/store.py:16-17)."""
    return pathlib.Path(".regression")


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
    from scipy.signal import fftconvolve

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


# per-set generation character, mirroring the reference's curated sets
# (docs/regression.rst:4-12): set 6 = 100 "well-modeled" blends (the set-1
# analog: fewer, better-separated, cleaner sources), set 4 = 50 random
# blends, set 5 = 14 hard crowded blends
_SET_PARAMS = {
    4: {},
    5: {"min_sep": 4.0, "noise_sigma": 0.12},
    6: {"n_range": (2, 7), "min_sep": 8.0, "noise_sigma": 0.08},
    # set 7 goes beyond the reference's tiers: very crowded scenes
    # (8-16 sources at 3 px separation) stressing detection completeness
    # and slot-packed deblending
    7: {"n_range": (8, 17), "min_sep": 3.0, "noise_sigma": 0.12},
    # set 8 hardens the realism toward the curated HSC-COSMOS material:
    # Spergel profiles (Sersic n ~ 0.5-4 range), per-band PSF
    # ellipticity, and correlated pixel noise (variance plane stays
    # marginal, like real coadds)
    8: {"n_range": (3, 9), "spergel_frac": 0.7, "psf_ellip": 0.25,
        "noise_corr": 0.8, "noise_sigma": 0.1},
}


def generate_blend_set(set_id=4, n=50, seed=None, root=None,
                       shape=(5, 58, 48)):
    """Write ``n`` deterministic synthetic blends as npz files under
    ``<root>/sets/set<set_id>/`` and return their paths (cached: existing
    complete sets are reused)."""
    root = pathlib.Path(root) if root else default_root()
    out_dir = root / "sets" / f"set{set_id}"
    paths = [out_dir / f"blend_{i:03d}.npz" for i in range(n)]
    if all(p.exists() for p in paths):
        return paths
    out_dir.mkdir(parents=True, exist_ok=True)
    if seed is None:
        seed = 1000 + set_id
    rng = np.random.default_rng(seed)
    params = dict(_SET_PARAMS.get(set_id, {}))
    n_range = params.pop("n_range", None)
    for p in paths:
        n_sources = (int(rng.integers(*n_range)) if n_range else None)
        np.savez_compressed(
            p, **generate_blend(rng, shape=shape, n_sources=n_sources,
                                **params))
    return paths


# --------------------------------------------------------------------------
# set 9: injected fakes on REAL HSC pixels — the curated sets' own recipe
# ("each blend is taken from the HSC-COSMOS deep patch 9813 with a fake
# source injected", ref docs/regression.rst:4-12), built from the
# reference's real cutouts instead of the unreachable AWS material.
# --------------------------------------------------------------------------

def _fit_band_gains(images, variance):
    """Per-band effective 1/gain: the slope of the real variance plane vs
    the image (HSC coadd variance = background floor + counts/gain), fit
    on bright pixels.  Used to give injected fakes a shot-noise variance
    contribution consistent with the real plane."""
    slopes = []
    for b in range(images.shape[0]):
        i = images[b].ravel().astype(np.float64)
        v = variance[b].ravel().astype(np.float64)
        sel = i > 5 * np.median(np.abs(i))
        if sel.sum() >= 50:
            a = np.vstack([i[sel], np.ones(sel.sum())]).T
            slope = float(np.linalg.lstsq(a, v[sel], rcond=None)[0][0])
        else:
            slope = 0.0
        slopes.append(max(slope, 0.0))
    return np.asarray(slopes, np.float64)


def _dihedral(arr, t):
    """Shape-preserving dihedral transform t in {0: id, 1: flip-y,
    2: flip-x, 3: rot180} on the trailing two axes."""
    if t == 1:
        return arr[..., ::-1, :]
    if t == 2:
        return arr[..., :, ::-1]
    if t == 3:
        return arr[..., ::-1, ::-1]
    return arr


def _dihedral_yx(y, x, t, H, W):
    if t == 1:
        return H - 1 - y, x
    if t == 2:
        return y, W - 1 - x
    if t == 3:
        return H - 1 - y, W - 1 - x
    return y, x


def _load_real_tiles(data_dir):
    """The two real HSC-COSMOS cutouts of ``data_dir`` as background
    tiles.

    hsc_cosmos_35 carries a real per-pixel variance plane; hsc_cosmos
    ships without one, so its per-band variance is estimated by MAD
    (background-dominated, the harness's standard proxy — api.py
    ``_load_image_variance``) and its shot-noise gain is borrowed from
    the hsc_cosmos_35 fit (same instrument, same COSMOS patch).  PSFs are
    zero-padded to one common support so a set built from both tiles
    stacks into a single stream batch."""
    data_dir = pathlib.Path(data_dir)
    d35 = np.load(data_dir / "hsc_cosmos_35.npz", allow_pickle=True)
    dco = np.load(data_dir / "hsc_cosmos.npz", allow_pickle=True)
    im35 = d35["images"].astype(np.float32)
    var35 = d35["variance"].astype(np.float32)
    gains = _fit_band_gains(im35, var35)
    imco = dco["images"].astype(np.float32)
    sig = np.array([1.4826 * np.median(np.abs(b - np.median(b)))
                    for b in imco], np.float32)
    varco = np.broadcast_to((sig ** 2)[:, None, None], imco.shape).copy()

    p35 = d35["psfs"].astype(np.float32)
    pco = dco["psfs"].astype(np.float32)
    P = max(p35.shape[-1], pco.shape[-1])

    def _pad_psf(p):
        d = (P - p.shape[-1]) // 2
        return np.pad(p, ((0, 0), (d, d), (d, d)))

    tiles = []
    for d, im, var in ((d35, im35, var35), (dco, imco, varco)):
        tiles.append({
            "images": im, "variance": var,
            "psfs": _pad_psf(d["psfs"].astype(np.float32)),
            "catalog_yx": np.array([[float(r["y"]), float(r["x"])]
                                    for r in d["catalog"]]),
            "gains": gains,
        })
    return tiles


def generate_real_blend(rng, tiles, shape=(5, 58, 48), snr_range=(1.1, 2.3),
                        spergel_frac=0.5):
    """One injected-fake-on-real-pixels blend dict.

    The background is a real HSC cutout (optionally cropped, under a
    random shape-preserving flip — flips of real pixels keep the noise
    field, PSF anisotropy, and source population real); ONE fake source
    (star or galaxy, the set-8 profile family) is convolved with the
    REAL per-band PSFs and added, together with a shot-noise variance
    contribution and its Gaussian realization at the fitted per-band
    gain.  The catalog carries the real HSC positions (scored for
    astrometry/detection) plus the fake with full truth-intensity
    images (scored for photometry/shape like the curated sets' fakes,
    ref testing/measure.py:62-76)."""
    from scipy.signal import fftconvolve

    C, H, W = shape
    filters = list(FILTERS)[:C]

    tile = tiles[int(rng.integers(len(tiles)))]
    th, tw = tile["images"].shape[-2:]
    oy = int(rng.integers(0, th - H + 1))
    ox = int(rng.integers(0, tw - W + 1))
    t = int(rng.integers(4))
    images = _dihedral(tile["images"][:, oy:oy + H, ox:ox + W],
                       t).astype(np.float32).copy()
    variance = _dihedral(tile["variance"][:, oy:oy + H, ox:ox + W],
                         t).astype(np.float32).copy()
    psfs = _dihedral(tile["psfs"], t).astype(np.float32).copy()
    gains = tile["gains"]

    real_yx = []
    for y, x in tile["catalog_yx"]:
        y, x = y - oy, x - ox
        # rounded position must stay in frame: the host init paths index
        # images[:, round(y), round(x)] (lite/initialization.py)
        if 0 <= round(y) < H and 0 <= round(x) < W:
            real_yx.append(_dihedral_yx(y, x, t, H, W))

    # fake position: usually near a real source (that is what makes it a
    # BLEND test), rejection-sampled off exact overlaps
    for _ in range(200):
        if real_yx and rng.random() < 0.75:
            cy, cx = real_yx[int(rng.integers(len(real_yx)))]
            r = rng.uniform(3.0, 9.0)
            a = rng.uniform(0, 2 * np.pi)
            y, x = cy + r * np.sin(a), cx + r * np.cos(a)
        else:
            y, x = rng.uniform(6, H - 7), rng.uniform(6, W - 7)
        if not (6 <= y < H - 7 and 6 <= x < W - 7):
            continue
        if all((y - ry) ** 2 + (x - rx) ** 2 >= 2.0 ** 2
               for ry, rx in real_yx):
            break

    # unit-total-flux unconvolved profile (the set-8 family: stars,
    # exp/gauss, Spergel)
    is_star = rng.random() < 0.25
    img = np.zeros((H, W), np.float32)
    iy, ix = int(round(y)), int(round(x))
    if is_star:
        radius = 0.0
        img[iy, ix] = 1.0
    else:
        radius = float(rng.uniform(1.0, 4.0))
        q = float(rng.uniform(0.4, 1.0))
        angle = float(rng.uniform(0, np.pi))
        size = min(2 * int(4 * radius) + 21, 2 * min(H, W) - 1)
        yy, xx = np.mgrid[:size, :size] - (size - 1) / 2.0
        c, s = np.cos(angle), np.sin(angle)
        u = (c * xx + s * yy) / max(q, 0.2)
        v = -s * xx + c * yy
        r = np.sqrt(u ** 2 + v ** 2) / max(radius, 0.3)
        if rng.random() < spergel_frac:
            nu = float(rng.uniform(-0.6, 1.5))
            prof = _spergel_nu(r, nu)
        else:
            kind = "exp" if rng.random() < 0.6 else "gauss"
            prof = (np.exp(-1.67835 * r) if kind == "exp"
                    else np.exp(-0.5 * r ** 2)).astype(np.float32)
        h = size // 2
        ys = slice(max(0, iy - h), min(H, iy + h + 1))
        xs = slice(max(0, ix - h), min(W, ix + h + 1))
        pys = slice(ys.start - (iy - h), size - ((iy + h + 1) - ys.stop))
        pxs = slice(xs.start - (ix - h), size - ((ix + h + 1) - xs.stop))
        img[ys, xs] = prof[pys, pxs]
    img /= max(img.sum(), 1e-12)

    sed = rng.dirichlet(np.full(C, 2.0))
    # flux from a target detection SNR: peak of the PSF-convolved fake
    # over the REAL noise at that pixel, in its best band
    conv_unit = np.stack([fftconvolve(img, psfs[b], mode="same")
                          for b in range(C)])
    with np.errstate(divide="ignore"):
        snr_per_unit = np.max(sed[:, None, None] * conv_unit
                              / np.sqrt(np.maximum(variance, 1e-12)))
    target_snr = 10 ** rng.uniform(*snr_range)
    flux = float(target_snr / max(snr_per_unit, 1e-12))

    truth = (flux * sed[:, None, None] * img[None]).astype(np.float32)
    conv = (flux * sed[:, None, None] * conv_unit).astype(np.float32)
    var_fake = (gains[:, None, None] * np.maximum(conv, 0.0)).astype(
        np.float32)
    images += conv + (rng.standard_normal(conv.shape)
                      * np.sqrt(var_fake)).astype(np.float32)
    variance += var_fake

    dtype = [("index", "<i8"), ("x", "<f8"), ("y", "<f8"), ("is_star", "?"),
             ("is_fake", "?"), ("radius", "<f8"), ("sed", "<f8", (C,))]
    dtype += [(f"intensity_{f}", "<f4", (H, W)) for f in filters]
    catalog = np.zeros(len(real_yx) + 1, dtype=dtype)
    for i, (ry, rx) in enumerate(real_yx):
        catalog[i]["index"] = i
        catalog[i]["y"], catalog[i]["x"] = ry, rx
        # real sources carry no truth intensity (all-zero images =
        # unscored for photometry/shape; measure._truth_diff skips them)
    k = len(real_yx)
    catalog[k]["index"] = k
    catalog[k]["y"], catalog[k]["x"] = y, x
    catalog[k]["is_star"] = is_star
    catalog[k]["is_fake"] = True
    catalog[k]["radius"] = radius
    catalog[k]["sed"] = sed
    for b, f in enumerate(filters):
        catalog[k][f"intensity_{f}"] = truth[b]

    return {
        "images": images,
        "variance": variance,
        "psfs": psfs,
        "filters": np.asarray(filters),
        "catalog": catalog,
    }


def generate_real_blend_set(set_id=9, n=50, seed=None, root=None,
                            data_dir="data"):
    """Write ``n`` deterministic injected-fake-on-real-HSC-pixels blends
    (cached like the synthetic sets), from the cutouts in ``data_dir``
    (the reference's ``data/`` directory)."""
    root = pathlib.Path(root) if root else default_root()
    out_dir = root / "sets" / f"set{set_id}"
    paths = [out_dir / f"blend_{i:03d}.npz" for i in range(n)]
    if all(p.exists() for p in paths):
        return paths
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1000 + set_id if seed is None else seed)
    tiles = _load_real_tiles(data_dir)
    for p in paths:
        np.savez_compressed(p, **generate_real_blend(rng, tiles))
    return paths
