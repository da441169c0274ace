"""Generated stand-ins for the reference data files that the tutorial
examples read (:mod:`scarlet_tpu_torch.examples`), none of which the
repository holds.  One function per file, each returning the dict that
the example's ``load()`` returns, with the file's keys and dtypes, from
explicit ``numpy.random.default_rng`` seeds:

* :func:`hsc_cosmos_35`: a :func:`generate_blend` of the HSC blend's
  size (5 bands, 58 x 48, 7 sources), the first of :func:`ot_blends`;
* :func:`psf_unmatched_sim`: a generated blend with per-band PSFs and
  star flags in its catalog;
* :func:`testdata_3_0`: a generated blend whose last source stands for
  the neighbouring blend that the file's ``footprint`` masks;
* :func:`lsbg`: the large generated scene plus a diffuse exponential disk
  (:func:`lsbg_images`);
* :func:`test_resampling`: the :func:`testing.multires.make_pair` scene
  rotated by 28 degrees, its low-resolution image spread over five bands
  as the HSC cutout and its high-resolution one as the HST cutout, with
  their WCS objects in place of what ``utils.fits.read_fits`` returns.

The multiresolution example makes its own data (its ``load()``).

A stand-in is used only by passing its dict to an example's ``run()``.
"""
from __future__ import annotations

import numpy as np

from .blendsets import generate_blend

__all__ = ["ot_blends", "lsbg_images", "hsc_cosmos_35", "psf_unmatched_sim",
           "testdata_3_0", "lsbg", "test_resampling"]


def ot_blends(n=16, seed=11, shape=(5, 58, 48), n_sources=7):
    """``n`` generated blends of ``shape`` with ``n_sources`` sources each,
    from ``default_rng(seed)`` (by default hsc_cosmos_35's size)."""
    rng = np.random.default_rng(seed)
    return [generate_blend(rng, shape=shape, n_sources=n_sources)
            for _ in range(n)]


def lsbg_images(d, radius=30.0, peak=0.5):
    """Blend ``d`` with a diffuse exponential disk at the centre (scale
    radius ``radius`` px, peak ``peak`` times each band's noise sigma,
    convolved with the band's PSF): a stand-in for the reference's
    lsbg.pkl.  Returns (the new blend dict, the disk's images)."""
    from scipy.signal import fftconvolve

    C, H, W = d["images"].shape
    yy, xx = np.mgrid[:H, :W]
    disk = np.exp(-np.hypot(yy - H // 2, xx - W // 2) / radius)
    sigma = np.sqrt(np.median(d["variance"], axis=(1, 2)))
    bands = np.stack([fftconvolve(disk, p / p.sum(), mode="same")
                      for p in d["psfs"]])
    bands *= (peak * sigma / bands.max(axis=(1, 2)))[:, None, None]
    out = dict(d)
    out["images"] = (d["images"] + bands).astype(np.float32)
    return out, bands


def hsc_cosmos_35(seed=11, shape=(5, 58, 48), n_sources=7):
    """hsc_cosmos_35.npz: ``images``, ``variance`` (float32, (5, H, W)),
    ``psfs`` (float32, (5, 21, 21)), ``catalog`` (records with ``y``,
    ``x``) and ``filters``: the first of :func:`ot_blends`, its catalog
    ordered as the file's is, the brightest galaxy first (the
    starlet_source example models ``catalog[0]`` as that galaxy), then
    the other galaxies and the stars, each by falling flux.  As in the
    file, the brightest galaxy is bright enough for two components at the
    examples' ``min_snr=30`` (PSF SNR 60 or more; the display tutorial
    shows a two-component source by component): its true intensity is
    added to the images once more, and its catalog row says so."""
    d = dict(ot_blends(1, seed, shape, n_sources)[0])
    cat = d["catalog"]
    flux = sum(cat[f"intensity_{f}"].sum(axis=(1, 2)) for f in d["filters"])
    cat = cat[np.lexsort((-flux, cat["is_star"]))]
    if not cat[0]["is_star"]:
        d["images"] = (d["images"] + np.stack(
            [cat[0][f"intensity_{f}"] for f in d["filters"]])).astype(
                np.float32)
        for f in d["filters"]:
            cat[0][f"intensity_{f}"] *= 2
    d["catalog"] = cat
    return d


def psf_unmatched_sim(seed=5, shape=(5, 58, 48), n_sources=6):
    """psf_unmatched_sim.npz: ``images`` and ``psfs`` per band (the PSF
    widths differ by band), ``filters`` and a ``catalog`` with ``index``,
    ``y``, ``x`` and ``is_star``."""
    return generate_blend(np.random.default_rng(seed), shape=shape,
                          n_sources=n_sources)


def testdata_3_0(seed=3, shape=(5, 58, 48), n_sources=6):
    """testdata_3_0.npz: ``images``, ``variance``, ``psfs``, ``centers``
    ((K, 2) int, y and x) and ``footprint`` ((H, W) bool, True where a
    neighbouring blend sits): the last generated source is that neighbour,
    and the footprint is where its true intensity, summed over the bands,
    exceeds 1e-3 of its peak."""
    d = generate_blend(np.random.default_rng(seed), shape=shape,
                       n_sources=n_sources)
    cat = d["catalog"]
    truth = sum(cat[-1][f"intensity_{f}"] for f in d["filters"])
    footprint = truth > 1e-3 * truth.max()
    centers = np.round(np.stack([cat["y"][:-1], cat["x"][:-1]],
                                axis=1)).astype(int)
    return {"images": d["images"], "variance": d["variance"],
            "psfs": d["psfs"], "centers": centers, "footprint": footprint}


def lsbg(seed=12, shape=(5, 128, 128), n_sources=24):
    """lsbg.pkl: ``images`` (float32), ``channels`` and ``psfs``; by
    default the large scene of the object tree's checks (``seed`` 12 =
    11 + 1) with the disk of :func:`lsbg_images`."""
    d, _ = lsbg_images(ot_blends(1, seed, shape, n_sources)[0])
    return {"images": d["images"], "channels": [str(f) for f in d["filters"]],
            "psfs": d["psfs"]}


# the HSC/HST stand-in: the multi-resolution pair's rotation, the five
# HSC bands' factors on its low-resolution image, and the flux scale that
# gives the example's unweighted fit the multi-resolution tests'
# signal-to-noise (their weight of 400; at scale 1 the fit stops on the
# loss's first rise, in both packages)
RESAMPLING_ROTATION = np.deg2rad(28)
RESAMPLING_SED = (1.0, 0.9, 0.8, 0.7, 0.6)
RESAMPLING_FLUX = 20.0


def test_resampling():
    """test_resampling/*.fits: ``hsc`` (float32, (5, 24, 24)) and
    ``psf_hsc`` ((5, 21, 21)), ``hst`` ((64, 64)) and ``psf_hst``
    ((21, 21)), ``wcs_hsc`` and ``wcs_hst``: the multi-resolution test
    pair rotated by RESAMPLING_ROTATION, both images times
    RESAMPLING_FLUX, the low-resolution one also times each band's
    RESAMPLING_SED factor as the HSC cutout."""
    from .multires import make_pair

    obs_hr, obs_lr, data_hr, data_lr = make_pair(
        rotation_lr=RESAMPLING_ROTATION, device="cpu")
    sed = np.asarray(RESAMPLING_SED, np.float32)[:, None, None]
    psf_lr = obs_lr.psf.get_model().numpy()
    return {"hsc": (RESAMPLING_FLUX * data_lr[None] * sed).astype(
                np.float32),
            "psf_hsc": np.repeat(psf_lr, len(sed), axis=0),
            "wcs_hsc": obs_lr.wcs,
            "hst": (RESAMPLING_FLUX * data_hr).astype(np.float32),
            "psf_hst": obs_hr.psf.get_model().numpy()[0],
            "wcs_hst": obs_hr.wcs}
