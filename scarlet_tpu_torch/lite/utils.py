"""Lite utilities (host-side numpy).  Behavioral reference:
scarlet/lite/utils.py."""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import erfc

from ..bbox import Box, overlapped_slices
from ..initialization import get_minimal_boxsize

__all__ = [
    "to_numpy",
    "insert_image",
    "project_morph_to_center",
    "integrated_gaussian",
    "integrated_circular_gaussian",
    "get_circle_mask",
    "host_convolve",
]


def to_numpy(x):
    """A host numpy array of ``x`` (a tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def insert_image(image_box, sub_box, sub_image, fill=0, dtype=None):
    """Place ``sub_image`` (bounded by ``sub_box``) into a new image bounded
    by ``image_box``.  Ref: lite/utils.py:9-39."""
    sub_image = to_numpy(sub_image)
    if dtype is None:
        dtype = sub_image.dtype
    if fill != 0:
        image = np.full(image_box.shape, fill, dtype=dtype)
    else:
        image = np.zeros(image_box.shape, dtype=dtype)
    slices = overlapped_slices(image_box, sub_box)
    image[slices[0]] = sub_image[slices[1]]
    return image


def project_morph_to_center(morph, center, bbox, fullbox, boxsize=None):
    """Center an uncentered morphology in a minimal odd square box.
    Ref: lite/utils.py:41-103."""
    morph = to_numpy(morph)
    if bbox.contains(center):
        size = 2 * max(
            (
                center[0] - bbox.start[-2],
                bbox.stop[0] - center[-2],
                center[1] - bbox.start[-1],
                bbox.stop[1] - center[-1],
            )
        )
    else:
        size = 0

    if boxsize is None:
        boxsize = get_minimal_boxsize(size)

    bottom = center[0] - boxsize // 2
    top = center[0] + boxsize // 2 + 1
    left = center[1] - boxsize // 2
    right = center[1] + boxsize // 2 + 1
    centered_box = Box.from_bounds((bottom, top), (left, right))

    centered = np.zeros(centered_box.shape, dtype=morph.dtype)
    slices = overlapped_slices(centered_box, fullbox)
    centered[slices[0]] = morph[slices[1]]
    return centered, centered_box


def integrated_gaussian(X, sigma):
    """1D pixel-integrated Gaussian. Ref: lite/utils.py:106-124."""
    sqrt2 = np.sqrt(2)
    lhs = erfc((0.5 - X) / (sqrt2 * sigma))
    rhs = erfc((2 * X + 1) / (2 * sqrt2 * sigma))
    return np.sqrt(np.pi / 2) * sigma * (1 - lhs + 1 - rhs)


def integrated_circular_gaussian(X=None, Y=None, sigma=0.8):
    """Default 15x15 pixel-integrated model PSF.
    Ref: lite/utils.py:127-156."""
    if X is None:
        if Y is None:
            X = np.arange(-7, 8)
            Y = X
        else:
            raise ValueError("specify both X and Y, or neither")
    result = integrated_gaussian(X, sigma)[None, :] * \
        integrated_gaussian(Y, sigma)[:, None]
    return result / np.sum(result)


def get_circle_mask(diameter, dtype=np.float64):
    """Boolean disk image. Ref: lite/utils.py:159-191."""
    c = (diameter - 1) / 2
    r = diameter / 2 if diameter % 2 == 0 else c
    X = np.arange(diameter)
    X, Y = np.meshgrid(X, X)
    R = np.sqrt((X - c) ** 2 + (Y - c) ** 2)
    circle = np.ones((diameter, diameter), dtype=dtype)
    circle[R > r] = 0
    return circle


def host_convolve(observation, image):
    """Per-band convolution to the observed seeing on the host (scipy FFT),
    for init and measurement code whose shapes vary per source."""
    kernel = observation.diff_kernel
    if kernel is None:
        return to_numpy(image)
    from scipy.signal import fftconvolve

    image = to_numpy(image)
    kernel = to_numpy(kernel.image)
    return np.stack([
        fftconvolve(image[b], kernel[b], mode="same")
        for b in range(image.shape[0])
    ]).astype(image.dtype, copy=False)
