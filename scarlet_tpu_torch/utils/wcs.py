"""Self-contained world coordinate system (gnomonic/TAN + affine).

The port's own copy of ``scarlet_tpu/utils/wcs.py`` (numpy only).  It
implements the subset of the ``astropy.wcs.WCS`` interface the framework
uses (``.wcs.pc/.cd``, ``.wcs.crpix``, ``.celestial``,
``world_to_pixel_values``, ``pixel_to_world_values``, ``deepcopy``) with an
exact spherical TAN (gnomonic) projection, so multi-resolution rendering
works without astropy.  When astropy is present, real WCS objects pass
through the same code paths unchanged (duck typing).
"""
from __future__ import annotations

import copy

import numpy as np

__all__ = ["AffineWCS", "make_tan_wcs"]


class _WCSParams:
    """Container mirroring astropy's ``wcs.wcs`` attribute block."""

    def __init__(self, crpix, crval, pc, cdelt, ctype):
        self.crpix = np.asarray(crpix, float)   # 1-based (FITS convention)
        self.crval = np.asarray(crval, float)   # deg
        self.pc = np.asarray(pc, float)
        self.cdelt = np.asarray(cdelt, float)
        self.ctype = list(ctype)


class AffineWCS:
    """TAN-projected celestial WCS over an affine pixel->intermediate map.

    Follows the FITS convention: intermediate coords (deg)
    ``q = (pc @ ((p+1) - crpix)) * cdelt`` with 0-based pixel ``p`` in
    (x, y) order, then gnomonic de-projection around ``crval``.
    """

    def __init__(self, crpix, crval, pc, cdelt, ctype=("RA---TAN", "DEC--TAN"),
                 array_shape=None):
        # fold cdelt into pc (CD-matrix style), matching astropy's behavior
        # for CD-defined WCS: framework code reads `wcs.wcs.pc` as the full
        # affine (see ops/interpolation.get_affine)
        pc = np.asarray(pc, float) * np.asarray(cdelt, float)[:, None]
        self.wcs = _WCSParams(crpix, crval, pc, np.ones(2), ctype)
        self.array_shape = array_shape

    # astropy API surface ---------------------------------------------------
    @property
    def celestial(self):
        return self

    @property
    def cd(self):
        return self.wcs.pc * self.wcs.cdelt[:, None].T

    def deepcopy(self):
        return copy.deepcopy(self)

    def _cd(self):
        # effective CD matrix (deg/pixel)
        return self.wcs.pc * self.wcs.cdelt[None, :].T

    def pixel_to_world_values(self, pixel):
        """(N, 2) 0-based (x, y) pixels -> (N, 2) (ra, dec) deg."""
        pixel = np.atleast_2d(np.asarray(pixel, float))
        cd = self._cd()
        rel = pixel + 1.0 - self.wcs.crpix[None, :]
        xi, eta = (cd @ rel.T)  # deg
        xi = np.deg2rad(xi)
        eta = np.deg2rad(eta)
        ra0 = np.deg2rad(self.wcs.crval[0])
        dec0 = np.deg2rad(self.wcs.crval[1])
        # gnomonic de-projection
        denom = np.cos(dec0) - eta * np.sin(dec0)
        ra = ra0 + np.arctan2(xi, denom)
        dec = np.arctan(
            np.cos(ra - ra0) * (np.sin(dec0) + eta * np.cos(dec0)) / denom
        )
        return np.stack([np.rad2deg(ra), np.rad2deg(dec)], axis=1)

    def world_to_pixel_values(self, world):
        """(N, 2) (ra, dec) deg -> (N, 2) 0-based (x, y) pixels."""
        world = np.atleast_2d(np.asarray(world, float))
        ra = np.deg2rad(world[:, 0])
        dec = np.deg2rad(world[:, 1])
        ra0 = np.deg2rad(self.wcs.crval[0])
        dec0 = np.deg2rad(self.wcs.crval[1])
        # gnomonic projection
        cosc = np.sin(dec0) * np.sin(dec) + \
            np.cos(dec0) * np.cos(dec) * np.cos(ra - ra0)
        xi = np.cos(dec) * np.sin(ra - ra0) / cosc
        eta = (np.cos(dec0) * np.sin(dec)
               - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)) / cosc
        q = np.stack([np.rad2deg(xi), np.rad2deg(eta)], axis=1)
        cd_inv = np.linalg.inv(self._cd())
        rel = (cd_inv @ q.T).T
        return rel + self.wcs.crpix[None, :] - 1.0

    def __repr__(self):
        return (f"AffineWCS(crpix={self.wcs.crpix}, crval={self.wcs.crval}, "
                f"cd={self._cd().tolist()})")


def make_tan_wcs(pixel_scale_arcsec, shape, crval=(150.0, 2.0), rotation=0.0,
                 crpix=None):
    """Convenience TAN WCS: square pixels of ``pixel_scale_arcsec``, rotated
    by ``rotation`` radians, centered on the image center by default."""
    H, W = shape
    scale = pixel_scale_arcsec / 3600.0
    c, s = np.cos(rotation), np.sin(rotation)
    # negative RA scale: sky convention (RA increases to the left)
    pc = np.array([[-c, s], [s, c]])
    if crpix is None:
        crpix = (W / 2 + 0.5, H / 2 + 0.5)
    return AffineWCS(crpix=crpix, crval=crval, pc=pc,
                     cdelt=(scale, scale), array_shape=shape)
