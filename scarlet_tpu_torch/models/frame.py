"""Model frame: spatial/spectral metadata and coordinate transforms.
Port of ``scarlet_tpu/models/frame.py`` (host numpy geometry; PSFs hold
CPU tensors).

Behavioral reference: scarlet/frame.py.
"""
from __future__ import annotations

import logging

import numpy as np

from ..bbox import Box
from ..ops import interpolation
from .psf import PSF, ImagePSF

logger = logging.getLogger("scarlet_tpu_torch.frame")

__all__ = ["Frame"]


class Frame:
    """Shape, channels, WCS, and PSF of a (model or data) frame.

    Ref: scarlet/frame.py:12-50.
    """

    def __init__(self, shape, channels, wcs=None, psf=None, dtype=np.float32):
        self._bbox = Box(shape)
        assert len(channels) == self.C
        self.channels = channels

        if wcs is not None:
            # duck-typed: astropy.wcs.WCS or scarlet_tpu_torch.utils.AffineWCS
            assert hasattr(wcs, "pixel_to_world_values") or \
                hasattr(wcs, "celestial"), f"not a WCS: {type(wcs)}"
            self.wcs = wcs
        else:
            self.wcs = None

        if psf is None:
            logger.warning("No PSF specified. Possible, but dangerous!")
            self._psf = None
        elif isinstance(psf, PSF):
            self._psf = psf
        else:
            self._psf = ImagePSF(psf)

        self.dtype = dtype

    @property
    def bbox(self):
        return self._bbox

    @property
    def shape(self):
        return self._bbox.shape

    @property
    def C(self):
        return self._bbox.shape[0]

    @property
    def Ny(self):
        return self._bbox.shape[1]

    @property
    def Nx(self):
        return self._bbox.shape[2]

    @property
    def psf(self):
        return self._psf

    def get_pixel(self, sky_coord):
        """World -> pixel (y, x). Ref: frame.py:84-104."""
        sky = np.array(sky_coord, dtype=np.float64).reshape(-1, 2)
        if self.wcs is not None:
            wcs_ = self.wcs.celestial
            pixel = np.array(wcs_.world_to_pixel_values(sky)).reshape(-1, 2)
            pixel = np.flip(pixel, axis=-1)
        else:
            pixel = sky
        if pixel.size == 2:
            return pixel[0]
        return pixel

    def get_sky_coord(self, pixel):
        """Pixel (y, x) -> world. Ref: frame.py:106-126."""
        pix = np.array(pixel, dtype=np.float64).reshape(-1, 2)
        if self.wcs is not None:
            wcs_ = self.wcs.celestial
            pix = np.flip(pix, axis=-1)
            sky = np.array(wcs_.pixel_to_world_values(pix))
        else:
            sky = pix
        if sky.size == 2:
            return sky[0]
        return sky

    def convert_pixel_to(self, target, pixel=None):
        """Map pixel coordinates of this frame into ``target``'s grid.

        Ref: frame.py:128-153.
        """
        if pixel is None:
            y, x = np.indices(self.shape[-2:], dtype=np.float64)
            pixel = np.stack((y.flatten(), x.flatten()), axis=1)
        ra_dec = self.get_sky_coord(pixel)
        # get_pixel already squeezes a single coordinate pair to shape (2,)
        return target.get_pixel(ra_dec)

    @staticmethod
    def from_observations(observations, model_psf=None, model_wcs=None,
                          obs_id=None, coverage="union"):
        """Construct the common model frame for a set of observations:
        highest-resolution WCS, narrowest PSF (sinc-upsampled if needed),
        union/intersection coverage padded by the widest PSF.

        Ref: scarlet/frame.py:155-287.
        """
        assert coverage in ("union", "intersection")
        if not hasattr(observations, "__iter__"):
            observations = (observations,)

        pix_tab = []
        fat_psf_size = None
        small_psf_size = None
        channels = []
        model_psf_temp = None
        psf_h = None
        for c, obs in enumerate(observations):
            channels = channels + list(obs.channels)
            h_temp = interpolation.get_pixel_size(
                interpolation.get_affine(obs.wcs))
            pix_tab.append(h_temp)
            psfs = obs.psf.get_model().numpy()
            for psf in psfs:
                psf_size = interpolation.get_psf_size(psf) * h_temp
                if fat_psf_size is None or psf_size > fat_psf_size:
                    fat_psf_size = psf_size
                if obs_id is None or c == obs_id:
                    if model_psf is None and (
                        small_psf_size is None or psf_size < small_psf_size
                    ):
                        small_psf_size = psf_size
                        model_psf_temp = ImagePSF(psf[np.newaxis, :, :])
                        psf_h = h_temp

        if obs_id is None:
            obs_ref = observations[np.where(pix_tab == np.min(pix_tab))[0][0]]
        else:
            obs_ref = observations[obs_id]

        if model_wcs is None:
            model_wcs = obs_ref.wcs

        h = interpolation.get_pixel_size(interpolation.get_affine(model_wcs))

        if model_psf is None:
            if psf_h > h:
                angle, h_ratio = interpolation.get_angles(model_wcs,
                                                          observations[-1].wcs)
                model_psf = ImagePSF(interpolation.sinc_interp_inplace(
                    model_psf_temp.get_model(), psf_h, h, angle))
            else:
                model_psf = model_psf_temp

        model_shape = (len(channels), 0, 0)
        model_frame = Frame(model_shape, channels=channels, psf=model_psf,
                            wcs=model_wcs)

        model_box = None
        for c, obs in enumerate(observations):
            if model_frame.wcs is obs.wcs:
                this_box = obs_ref.bbox[-2:]
            else:
                obs_coord = obs.convert_pixel_to(model_frame)
                y_min = int(np.floor(np.min(obs_coord[:, 0])))
                x_min = int(np.floor(np.min(obs_coord[:, 1])))
                y_max = int(np.ceil(np.max(obs_coord[:, 0])))
                x_max = int(np.ceil(np.max(obs_coord[:, 1])))
                this_box = Box.from_bounds((y_min, y_max + 1),
                                           (x_min, x_max + 1))
            if c == 0:
                model_box = this_box
            elif coverage == "union":
                model_box = model_box | this_box
            else:
                model_box = model_box & this_box

        # pad by the widest PSF half-width to prevent edge leakage
        pad_size = fat_psf_size / h / 2
        offset = (int(np.round(pad_size)), int(np.round(pad_size)))
        model_box = model_box - offset
        model_box.shape = tuple(s + 2 * o
                                for s, o in zip(model_box.shape, offset))

        model_wcs = model_wcs.deepcopy()
        model_wcs.wcs.crpix -= model_box.origin
        model_wcs.array_shape = model_box.shape

        frame_shape = (len(channels), *model_box.shape)
        model_frame = Frame(frame_shape, channels=channels, psf=model_psf,
                            wcs=model_wcs)

        for obs in observations:
            obs.match(model_frame)
        return model_frame
