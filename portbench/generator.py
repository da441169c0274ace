"""The traffic's blends: a frozen numpy copy of the port's blend generator
(``testing/blendsets.py``: ``_gaussian_psf``, ``_spergel_nu``,
``_profile``, ``generate_blend``) and of its model PSF
(``lite/utils.py``: ``integrated_gaussian``,
``integrated_circular_gaussian``), and the pool that a traffic file
describes.

``generate_blend`` draws from ``rng`` exactly as the port's does, so a
seed gives the port's blend bit for bit; it returns the noiseless scene
and the per-band noise level beside the noisy images, so that a flipped
copy can take a fresh noise draw, and leaves out the catalog's truth
images, which nothing here reads.  Numpy and scipy only.
"""
from __future__ import annotations

import numpy as np

FILTERS = "grizy"


def _gaussian_psf(sigma, size=21, e=0.0, angle=0.0):
    """Gaussian PSF, optionally elliptical: axis ratio ``1-e`` at
    position angle ``angle``."""
    yy, xx = np.mgrid[:size, :size] - (size - 1) / 2.0
    c, s = np.cos(angle), np.sin(angle)
    u = c * xx + s * yy
    v = -s * xx + c * yy
    q = max(1.0 - e, 0.3)
    p = np.exp(-(u ** 2 / q + v ** 2 * q) / (2 * sigma ** 2))
    return (p / p.sum()).astype(np.float32)


def _spergel_nu(r, nu):
    """Unit-peak Spergel (2010) radial profile ``(r)^nu K_nu(r)``."""
    from scipy.special import gamma, kv

    r = np.maximum(r, 1e-8)
    f = r ** nu * kv(nu, r)
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
    """One synthetic blend: a dict with ``images`` (noisy), ``clean`` (the
    noiseless scene convolved per band), ``sigma_b`` (per-band noise
    level), ``variance``, ``psfs`` and the ``centers`` (K, 2) float (y, x)
    of its sources.  Draws from ``rng`` as the port's ``generate_blend``
    does, in the same order."""
    from scipy.signal import fftconvolve

    C, H, W = shape
    sigmas = rng.uniform(1.1, 2.1, size=C).astype(np.float32)
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

    centers = []
    for _ in range(200):
        if len(centers) >= n_sources:
            break
        y = rng.uniform(6, H - 7)
        x = rng.uniform(6, W - 7)
        if all((y - cy) ** 2 + (x - cx) ** 2 >= min_sep ** 2
               for cy, cx in centers):
            centers.append((y, x))

    scene_truth = np.zeros((C, H, W), np.float32)
    for y, x in centers:
        is_star = rng.random() < 0.3
        sed = rng.dirichlet(np.full(C, 2.0)).astype(np.float64)
        flux = 10 ** rng.uniform(1.0, 2.7)
        if is_star:
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
        scene_truth += (sed[:, None, None] * img[None]).astype(np.float32)

    clean = np.stack([
        fftconvolve(scene_truth[b], psfs[b], mode="same")
        for b in range(C)
    ]).astype(np.float32)
    sigma_b = (noise_sigma * (1.0 + rng.uniform(-0.3, 0.3, size=C))
               ).astype(np.float32)
    noise = rng.standard_normal(clean.shape).astype(np.float32)
    if noise_corr > 0:
        k = _gaussian_psf(noise_corr, 2 * int(3 * noise_corr) + 1)
        noise = np.stack([fftconvolve(n, k, mode="same") for n in noise])
        noise /= np.sqrt(np.sum(k.astype(np.float64) ** 2)).astype(
            np.float32)
    images = clean + noise * sigma_b[:, None, None]
    variance = np.broadcast_to((sigma_b ** 2)[:, None, None],
                               images.shape).copy()
    return {"images": images, "clean": clean, "sigma_b": sigma_b,
            "variance": variance, "psfs": psfs,
            "centers": np.asarray(centers, np.float64).reshape(-1, 2)}


def integrated_gaussian(X, sigma):
    """1D pixel-integrated Gaussian."""
    from scipy.special import erfc

    sqrt2 = np.sqrt(2)
    lhs = erfc((0.5 - X) / (sqrt2 * sigma))
    rhs = erfc((2 * X + 1) / (2 * sqrt2 * sigma))
    return np.sqrt(np.pi / 2) * sigma * (1 - lhs + 1 - rhs)


def model_psf(sigma):
    """The (1, 15, 15) float32 pixel-integrated circular Gaussian model PSF
    (``integrated_circular_gaussian``)."""
    X = np.arange(-7, 8)
    result = integrated_gaussian(X, sigma)[None, :] * \
        integrated_gaussian(X, sigma)[:, None]
    return (result / np.sum(result))[None].astype(np.float32)


# the shape-preserving flips of a (..., H, W) stack: as generated, up-down,
# left-right, both
FLIPS = ((), (-2,), (-1,), (-2, -1))


def source_counts(groups, rng):
    """The source count of each base blend, in an order drawn from ``rng``:
    ``groups`` lists [lo, hi, n] entries, n blends with counts lo to hi,
    each count equally often.  The same multiset for every seed."""
    counts = []
    for lo, hi, n in groups:
        span = int(hi) - int(lo) + 1
        if int(n) % span:
            raise ValueError(f"{n} blends do not spread evenly over the "
                             f"{span} source counts {lo}-{hi}")
        counts.append(np.repeat(np.arange(int(lo), int(hi) + 1),
                                int(n) // span))
    return rng.permutation(np.concatenate(counts))


def make_pool(seed, shape, traffic):
    """The pool of one run: base blends of ``shape`` (C, H, W) with the
    source counts of ``traffic["sources"]`` (:func:`source_counts`), each
    in the flips ``FLIPS`` (as generated, then each flip with a fresh
    noise draw).  Catalogs are packed to one (K, 2) layout with
    ``active``.  The blends are ordered one flip after another, each flip
    in base order, so that a call of a whole number of flips holds every
    base blend equally often.  Returns numpy stacks: images, variance, psfs, centers
    (int32), active (bool), and ``n_sources`` (per blend)."""
    rng = np.random.default_rng(int(seed))
    counts = source_counts(traffic["sources"], rng)
    n_base = len(counts)
    gen_kw = dict(traffic.get("generator", {}))
    C, H, W = shape
    per_flip = {t: [] for t in range(len(FLIPS))}
    for i in range(n_base):
        b = generate_blend(rng, shape=tuple(shape),
                           n_sources=int(counts[i]), **gen_kw)
        for t, axes in enumerate(FLIPS):
            if t == 0:
                images, clean = b["images"], None
            else:
                clean = np.flip(b["clean"], axes)
                noise = rng.standard_normal(clean.shape).astype(np.float32)
                images = clean + noise * b["sigma_b"][:, None, None]
            cy = np.round(b["centers"][:, 0]).astype(np.int32)
            cx = np.round(b["centers"][:, 1]).astype(np.int32)
            if -2 in axes:
                cy = H - 1 - cy
            if -1 in axes:
                cx = W - 1 - cx
            per_flip[t].append(dict(
                images=np.ascontiguousarray(images),
                variance=b["variance"],
                psfs=np.ascontiguousarray(np.flip(b["psfs"], axes)),
                centers=np.stack([cy, cx], axis=-1)))
    order = [per_flip[t][i] for t in range(len(FLIPS))
             for i in range(n_base)]
    K = max(len(b["centers"]) for b in order)
    n = len(order)
    centers = np.zeros((n, K, 2), np.int32)
    active = np.zeros((n, K), bool)
    for j, b in enumerate(order):
        k = len(b["centers"])
        centers[j, :k] = b["centers"]
        active[j, :k] = True
    return dict(images=np.stack([b["images"] for b in order]),
                variance=np.stack([b["variance"] for b in order]),
                psfs=np.stack([b["psfs"] for b in order]),
                centers=centers, active=active,
                n_sources=active.sum(axis=1))
