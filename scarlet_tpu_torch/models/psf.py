"""PSF models.  Port of ``scarlet_tpu/models/psf.py``.

The functional PSFs evaluate in float64 on the CPU (they feed the
renderers' host precomputations); ``GaussianPSF`` integrates each pixel
exactly with ``erfc``, so narrow PSFs stay photometric.

Behavioral reference: scarlet/psf.py (file:line cited per class).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bbox import Box
from ..ops import fft as fft_ops
from .model import Model
from .parameter import Parameter, prepare_param

__all__ = ["PSF", "FunctionPSF", "GaussianPSF", "MoffatPSF", "ImagePSF",
           "normalize"]


def normalize(image):
    """Normalize a (C, H, W) PSF image to unit sum per band.
    Ref: scarlet/psf.py:9-17."""
    sums = image.sum(dim=(-2, -1))
    return image / sums[..., None, None]


class PSF(Model):
    """Abstract PSF: ``get_model(*parameters, offset=None)`` returns a
    centered (C, H, W) realization.  Ref: scarlet/psf.py:20-36."""

    def get_model(self, *parameters, offset=None):
        raise NotImplementedError


class FunctionPSF(PSF):
    """PSF with a functional radial form evaluated on a grid.
    Ref: scarlet/psf.py:39-78."""

    def __init__(self, *parameters, integrate=True, boxsize=None):
        super().__init__(*parameters)
        self.integrate = integrate

        if boxsize is None:
            boxsize = 15
        if boxsize % 2 == 0:
            boxsize += 1

        p0 = self.get_parameter(0).numpy()
        shape = (len(p0), boxsize, boxsize)
        origin = (0, -(boxsize // 2), -(boxsize // 2))
        self.bbox = Box(shape, origin=origin)

        self._Y = torch.arange(self.bbox.shape[-2], dtype=torch.float64) \
            + self.bbox.origin[-2]
        self._X = torch.arange(self.bbox.shape[-1], dtype=torch.float64) \
            + self.bbox.origin[-1]
        self.is_same = bool(np.all(p0 == p0[0]))
        self._d = self.bbox.D - 2

    def expand_dims(self, model):
        return model.reshape((1,) * self._d + tuple(model.shape))

    def _grid(self, offset):
        """The pixel grid minus ``offset`` (y, x), on the offset's device
        when it is a tensor."""
        if offset is None:
            return self._Y, self._X
        dev = offset.device if isinstance(offset, torch.Tensor) else None
        return (self._Y.to(dev) - offset[0], self._X.to(dev) - offset[1])


class GaussianPSF(FunctionPSF):
    """Circular Gaussian with exact pixel integration (erfc).
    Ref: scarlet/psf.py:80-142."""

    def __init__(self, sigma, integrate=True, boxsize=None):
        sigma = prepare_param(sigma, "sigma", fixed=True)
        if boxsize is None:
            boxsize = int(np.ceil(10 * np.max(sigma.value.numpy())))
        super().__init__(sigma, integrate=integrate, boxsize=boxsize)

    def get_model(self, *parameters, offset=None):
        sigma = self.get_parameter(0, *parameters)
        Y, X = self._grid(offset)

        def one(s):
            return self._f(Y, s)[:, None] * self._f(X, s)[None, :]

        if self.is_same:
            psfs = self.expand_dims(one(sigma[0]))
        else:
            psfs = torch.stack([one(s) for s in sigma], dim=0)
        return normalize(psfs)

    def _f(self, X, sigma):
        if not self.integrate:
            return torch.exp(-(X ** 2) / (2 * sigma ** 2))
        sqrt2 = np.sqrt(2)
        erfc = torch.special.erfc
        return (
            np.sqrt(np.pi / 2)
            * sigma
            * (
                1
                - erfc((0.5 - X) / (sqrt2 * sigma))
                + 1
                - erfc((2 * X + 1) / (2 * sqrt2 * sigma))
            )
        )


class MoffatPSF(FunctionPSF):
    """Symmetric 2D Moffat profile. Ref: scarlet/psf.py:145-202."""

    def __init__(self, alpha=4.7, beta=1.5, integrate=False, boxsize=None):
        alpha = prepare_param(alpha, "alpha", fixed=True)
        beta = prepare_param(beta, "beta", fixed=True)
        assert len(alpha) == len(beta)
        assert integrate is False, "In-pixel integration not implemented"
        if boxsize is None:
            boxsize = int(np.ceil(5 * np.max(alpha.value.numpy())))
        super().__init__(alpha, beta, integrate=integrate, boxsize=boxsize)
        # is_same must account for both parameters
        a, b = alpha.value.numpy(), beta.value.numpy()
        self.is_same = bool(np.all(a == a[0]) and np.all(b == b[0]))

    def get_model(self, *parameters, offset=None):
        alpha = self.get_parameter(0, *parameters)
        beta = self.get_parameter(1, *parameters)
        Y, X = self._grid(offset)

        if self.is_same:
            psfs = self.expand_dims(self._f(Y, X, alpha[0], beta[0]))
        else:
            psfs = torch.stack([self._f(Y, X, a, b)
                                for a, b in zip(alpha, beta)], dim=0)
        return normalize(psfs)

    def _f(self, Y, X, a, b):
        return (1 + (X[None, :] ** 2 + Y[:, None] ** 2) / a ** 2) ** -b


class ImagePSF(PSF):
    """PSF given as a centered image (its dtype kept, normalized per band).
    Ref: scarlet/psf.py:205-234."""

    def __init__(self, image):
        image = torch.as_tensor(image)
        if image.ndim == 2:
            image = image[None]
        image = Parameter(normalize(image), name="image", fixed=True)
        super().__init__(image)
        origin = (0, -(image.shape[1] // 2), -(image.shape[2] // 2))
        self.bbox = Box(image.shape, origin=origin)

    def get_model(self, *parameters, offset=None):
        image = self.get_parameter(0, *parameters)
        if offset is not None:
            image = fft_ops.shift(image, offset, return_fourier=False)
        return image
