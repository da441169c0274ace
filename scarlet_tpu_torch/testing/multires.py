"""A synthetic two-instrument scene for the multi-resolution path: three
Gaussian blobs observed by a high-resolution instrument (0.1"/pixel,
narrow PSF) and a low-resolution one (0.3"/pixel, wide PSF, optionally
rotated), both images known analytically.  The same scene as the JAX
package's ``tests/test_multiresolution.py:make_pair``, and optionally
several bands per instrument."""
from __future__ import annotations

import numpy as np

from ..models import ImagePSF, Observation
from ..utils import make_tan_wcs

__all__ = ["RA0", "DEC0", "BLOBS", "gaussian_image", "make_pair",
           "blob_centers"]

RA0, DEC0 = 150.0, 2.0
# scene blobs: (flux, dx arcsec, dy arcsec, sigma arcsec)
BLOBS = [
    (100.0, 0.0, 0.0, 0.35),
    (40.0, 0.9, -0.5, 0.25),
    (25.0, -0.8, 0.7, 0.5),
]
SIGMA_PSF_HR = 0.12   # arcsec
SIGMA_PSF_LR = 0.45


def gaussian_image(wcs, shape, blobs, pixel_arcsec):
    """A sum of 2D Gaussians (flux, sky dx/dy arcsec, sigma arcsec) on a
    pixel grid, in flux per pixel, float32."""
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(float)
    pix = np.stack([xx.ravel(), yy.ravel()], axis=1)
    world = wcs.pixel_to_world_values(pix)  # (N, 2) ra/dec deg
    ra0, dec0 = wcs.wcs.crval
    # small-field tangent-plane offsets in arcsec
    dx = (world[:, 0] - ra0) * np.cos(np.deg2rad(dec0)) * 3600
    dy = (world[:, 1] - dec0) * 3600
    img = np.zeros(H * W)
    area = pixel_arcsec ** 2
    for flux, bx, by, sigma in blobs:
        r2 = (dx - bx) ** 2 + (dy - by) ** 2
        img += flux * area / (2 * np.pi * sigma ** 2) * \
            np.exp(-r2 / (2 * sigma ** 2))
    return img.reshape(H, W).astype(np.float32)


def _colored(blobs, band, n_bands):
    """The blobs as band ``band`` of ``n_bands`` sees them: each blob's
    flux times a color of its own (the blobs as they are for one band)."""
    if n_bands == 1:
        return blobs
    return [(f * (1.0 + 0.3 * np.cos(band + 2.0 * i)), bx, by, s)
            for i, (f, bx, by, s) in enumerate(blobs)]


def make_pair(rotation_lr=0.0, scale_hr=0.1, scale_lr=0.3,
              shape_hr=(64, 64), shape_lr=(24, 24), device=None,
              bands=(1, 1)):
    """(obs_hr, obs_lr, data_hr, data_lr): two observations of the blobs
    on ``device``, and their images.

    ``bands = (n_hr, n_lr)``: channels of each instrument.  One channel
    ("hr", "lr") gives an (H, W) image, as the JAX test's pair.  More
    give (n, H, W) images, channels ``hr0 .. hr{n_hr-1}`` and ``lr0 ..``,
    in which each blob has a color of its own, different in every band of
    the pair (a joint fit of two surveys: 6 + 4 model channels at
    ``bands=(6, 4)``), every band of an instrument with its PSF."""
    crval = (RA0, DEC0)
    wcs_hr = make_tan_wcs(scale_hr, shape_hr, crval=crval)
    wcs_lr = make_tan_wcs(scale_lr, shape_lr, crval=crval,
                          rotation=rotation_lr)
    n_hr, n_lr = bands

    def observed(sigma_psf, band, n_bands):
        return [(f, bx, by, np.hypot(s, sigma_psf)) for f, bx, by, s in
                _colored(BLOBS, band, n_bands)]

    def images(wcs, shape, sigma_psf, scale, first, n):
        total = n_hr + n_lr if max(bands) > 1 else 1
        return np.stack([gaussian_image(wcs, shape,
                                        observed(sigma_psf, first + c, total),
                                        scale) for c in range(n)])

    data_hr = images(wcs_hr, shape_hr, SIGMA_PSF_HR, scale_hr, 0, n_hr)
    data_lr = images(wcs_lr, shape_lr, SIGMA_PSF_LR, scale_lr, n_hr, n_lr)
    psf_hr = gaussian_image(
        make_tan_wcs(scale_hr, (21, 21), crval=crval),
        (21, 21), [(1.0, 0, 0, SIGMA_PSF_HR)], scale_hr)[None]
    psf_lr = gaussian_image(
        make_tan_wcs(scale_lr, (21, 21), crval=crval, rotation=rotation_lr),
        (21, 21), [(1.0, 0, 0, SIGMA_PSF_LR)], scale_lr)[None]

    def names(prefix, n):
        return [prefix] if n == 1 else [f"{prefix}{c}" for c in range(n)]

    obs_hr = Observation(data_hr, wcs=wcs_hr,
                         psf=ImagePSF(np.repeat(psf_hr, n_hr, axis=0)),
                         channels=names("hr", n_hr), device=device)
    obs_lr = Observation(data_lr, wcs=wcs_lr,
                         psf=ImagePSF(np.repeat(psf_lr, n_lr, axis=0)),
                         channels=names("lr", n_lr), device=device)
    return (obs_hr, obs_lr, data_hr[0] if n_hr == 1 else data_hr,
            data_lr[0] if n_lr == 1 else data_lr)


def blob_centers(frame, B):
    """(B, 3, 2) model-frame (y, x) positions of the three blobs."""
    pts = []
    for _, dx, dy, _ in BLOBS:
        ra = RA0 + dx / 3600 / np.cos(np.deg2rad(DEC0))
        pts.append(np.asarray(frame.get_pixel((ra, DEC0 + dy / 3600)),
                              float))
    return np.tile(np.asarray(pts)[None], (B, 1, 1))
