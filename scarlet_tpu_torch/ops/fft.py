"""Centered FFT convolution on torch tensors (``torch.fft``; cuFFT on the
card, pocketfft on the CPU).

Conventions (behavioral reference: scarlet/fft.py:9-167):

* Images are stored with the object centered in the array.  Before an FFT
  the image is zero-padded to the FFT shape and rolled to FFT standard
  order with ``ifftshift``; after the inverse FFT it is rolled back with
  ``fftshift`` and center-cropped.
* For an odd array placed into an even shape, the center lands on the
  center-*right* pixel (``np.fft.fftshift`` convention): crop start index
  is ``(curr - new + 1) // 2`` and pad left width is
  ``(new - curr + 1) // 2``.

Kernel transforms are complex tensors.  The matmul-DFT convolution mode
of the JAX package is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.fft import next_fast_len

__all__ = [
    "centered",
    "zero_pad",
    "good_fft_shape",
    "good_fft_shape_even",
    "minimal_even_fft_shape",
    "minimal_same_fft_shape",
    "transform",
    "inverse_transform",
    "Fourier",
    "convolve",
    "convolve_fft",
    "match_psf",
]


def _normalize_axes(ndim, axes):
    if axes is None:
        axes = tuple(range(ndim))
    try:
        iter(axes)
    except TypeError:
        axes = (axes,)
    return tuple(a % ndim for a in axes)


def centered(arr, newshape, axes=None):
    """Center-crop ``arr`` to ``newshape`` (fftshift convention).
    Ref: scarlet/fft.py:9-36."""
    axes = _normalize_axes(arr.ndim, axes)
    if len(newshape) == arr.ndim and len(axes) != arr.ndim:
        newshape = [newshape[a] for a in axes]
    slices = [slice(None)] * arr.ndim
    for a, new in zip(axes, newshape):
        curr = arr.shape[a]
        if new > curr:
            raise ValueError(
                f"arr must be larger than newshape, got {tuple(arr.shape)} "
                f"-> {newshape}")
        start = (curr - new + 1) // 2
        slices[a] = slice(start, start + new)
    return arr[tuple(slices)]


def zero_pad(arr, newshape, axes=None):
    """Zero-pad ``arr`` to ``newshape`` (inverse of :func:`centered`).
    Ref: scarlet/fft.py:82-113."""
    axes = _normalize_axes(arr.ndim, axes)
    if len(newshape) == arr.ndim and len(axes) != arr.ndim:
        newshape = [newshape[a] for a in axes]
    widths = [(0, 0)] * arr.ndim
    for a, new in zip(axes, newshape):
        ds = new - arr.shape[a]
        left = (ds + 1) // 2
        widths[a] = (left, ds - left)
    # F.pad takes (last_lo, last_hi, second_to_last_lo, ...)
    flat = []
    for lo, hi in reversed(widths):
        flat.extend((lo, hi))
    return F.pad(arr, flat)


def good_fft_shape(im_or_shape1, im_or_shape2, padding=3, axes=None,
                   use_max=False):
    """Fast FFT shape for convolving two images along ``axes``:
    ``next_fast_len(s1 + s2 + padding)`` with the reference's even-dimension
    constraints.  Ref: scarlet/fft.py:116-167."""
    shape1 = np.asarray(getattr(im_or_shape1, "shape", im_or_shape1))
    shape2 = np.asarray(getattr(im_or_shape2, "shape", im_or_shape2))
    if len(shape1) != len(shape2):
        raise ValueError(
            f"img1 and img2 must have the same ndim, got {len(shape1)}, "
            f"{len(shape2)}")
    if axes is None:
        if use_max:
            shape = np.max([shape1, shape2], axis=0)
        else:
            shape = shape1 + shape2
    else:
        try:
            iter(axes)
        except TypeError:
            axes = [axes]
        shape = np.zeros(len(axes), dtype=int)
        for n, ax in enumerate(axes):
            if use_max:
                shape[n] = max(shape1[ax], shape2[ax])
            else:
                shape[n] = shape1[ax] + shape2[ax]

    shape = shape + padding
    shape = [next_fast_len(int(s)) for s in shape]
    while shape[-1] % 2 != 0:
        shape[-1] = next_fast_len(shape[-1] + 1)
    if shape2[-2] % 2 == 0:
        while shape[-2] % 2 != 0:
            shape[-2] = next_fast_len(shape[-2] + 1)
    return tuple(int(s) for s in shape)


def good_fft_shape_even(im_or_shape1, im_or_shape2, padding=3, axes=None,
                        use_max=False):
    """Like :func:`good_fft_shape` with every transformed dimension even."""
    shape = list(good_fft_shape(im_or_shape1, im_or_shape2, padding=padding,
                                axes=axes, use_max=use_max))
    for i in range(len(shape)):
        while shape[i] % 2 != 0:
            shape[i] = next_fast_len(shape[i] + 1)
    return tuple(shape)


def _next_even_5smooth(n):
    """Smallest even {2,3,5}-smooth integer >= n."""
    m = n + (n % 2)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 2


def minimal_even_fft_shape(im_or_shape1, im_or_shape2, axes=(-2, -1)):
    """Per transformed axis, the smallest even {2,3,5}-smooth size
    >= s1 + s2 - 1 (exact linear convolution)."""
    shape1 = np.asarray(getattr(im_or_shape1, "shape", im_or_shape1))
    shape2 = np.asarray(getattr(im_or_shape2, "shape", im_or_shape2))
    return tuple(
        _next_even_5smooth(int(shape1[ax] + shape2[ax] - 1)) for ax in axes)


def minimal_same_fft_shape(im_or_shape1, im_or_shape2, axes=(-2, -1)):
    """Smallest even {2,3,5}-smooth FFT shape whose center-cropped
    ('same'-size) circular convolution equals the linear one: wrap-around
    stays in the discarded margin when ``M >= s1 + (s2 - 1) // 2`` (odd
    kernel axes); even kernel axes keep the full ``s1 + s2 - 1``."""
    shape1 = np.asarray(getattr(im_or_shape1, "shape", im_or_shape1))
    shape2 = np.asarray(getattr(im_or_shape2, "shape", im_or_shape2))
    out = []
    for ax in axes:
        s1, s2 = int(shape1[ax]), int(shape2[ax])
        if s2 % 2 == 1:
            m = max(s1 + (s2 - 1) // 2, s2)
        else:
            m = s1 + s2 - 1
        out.append(_next_even_5smooth(m))
    return tuple(out)


def transform(image, fft_shape, axes=(-2, -1)):
    """rFFT of a centered image: pad -> ifftshift -> rfftn.
    Ref: scarlet/fft.py:255-273."""
    axes = _normalize_axes(image.ndim, axes)
    if len(fft_shape) != len(axes):
        raise ValueError(f"fft_shape {fft_shape} and axes {axes} mismatch")
    padded = zero_pad(image, fft_shape, axes)
    return torch.fft.rfftn(torch.fft.ifftshift(padded, axes), dim=axes)


def inverse_transform(kimage, fft_shape, real_shape, axes=(-2, -1)):
    """Inverse of :func:`transform`: irfftn -> fftshift -> center-crop to
    ``real_shape``.  Ref: scarlet/fft.py:200-243."""
    ndim = kimage.ndim
    axes = _normalize_axes(ndim, axes)
    image = torch.fft.irfftn(kimage, s=tuple(fft_shape), dim=axes)
    image = torch.fft.fftshift(image, axes)
    if len(real_shape) == ndim:
        crop = [real_shape[a] for a in axes]
    else:
        crop = list(real_shape)
    return centered(image, crop, axes)


class Fourier:
    """A real-space image with memoized rFFTs per (fft_shape, axes).
    Ref: scarlet/fft.py:170-313."""

    def __init__(self, image, image_fft=None):
        self._image = torch.as_tensor(image)
        self._fft = {} if image_fft is None else dict(image_fft)

    @staticmethod
    def from_fft(image_fft, fft_shape, image_shape, axes=None):
        if axes is None:
            axes = tuple(range(image_fft.ndim))
        axes = _normalize_axes(len(image_shape), axes)
        image = inverse_transform(image_fft, fft_shape, image_shape, axes)
        key = (tuple(fft_shape), tuple(axes))
        return Fourier(image, {key: image_fft})

    @property
    def image(self):
        return self._image

    @property
    def shape(self):
        return tuple(self._image.shape)

    def fft(self, fft_shape, axes):
        axes = _normalize_axes(self._image.ndim, axes)
        key = (tuple(fft_shape), tuple(axes))
        if key not in self._fft:
            self._fft[key] = transform(self._image, fft_shape, axes)
        return self._fft[key]


def _as_fourier(x):
    return x if isinstance(x, Fourier) else Fourier(x)


def convolve_fft(image, kernel_rfft, fft_shape, axes=(-2, -1),
                 real_shape=None):
    """Convolution with a precomputed kernel rFFT (complex tensor at
    ``fft_shape``); leading axes broadcast."""
    if real_shape is None:
        real_shape = tuple(image.shape)
    kimage = transform(image, fft_shape, axes)
    return inverse_transform(kimage * kernel_rfft, fft_shape, real_shape,
                             axes)


def convolve(image, kernel, padding=3, axes=(-2, -1), return_fourier=True):
    """Convolve ``image`` with a centered ``kernel``.
    Ref: scarlet/fft.py:368-396."""
    image = _as_fourier(image)
    kernel = _as_fourier(kernel)
    fft_shape = good_fft_shape(image.image, kernel.image, padding, axes)
    axes_n = _normalize_axes(image.image.ndim, axes)
    kimage = image.fft(fft_shape, axes_n) * kernel.fft(fft_shape, axes_n)
    result = Fourier.from_fft(kimage, fft_shape, image.shape, axes_n)
    if return_fourier:
        return result
    return result.image


def match_psf(psf1, psf2, padding=3, axes=(-2, -1), return_fourier=True):
    """Difference kernel ``k`` with ``psf2 * k = psf1`` (k-space ratio).
    Ref: scarlet/fft.py:334-365."""
    psf1 = _as_fourier(psf1)
    psf2 = _as_fourier(psf2)
    shape = psf2.shape if psf1.shape[0] < psf2.shape[0] else psf1.shape
    fft_shape = good_fft_shape(psf1.image, psf2.image, padding, axes)
    axes_n = _normalize_axes(psf1.image.ndim, axes)
    kimage = psf1.fft(fft_shape, axes_n) / psf2.fft(fft_shape, axes_n)
    result = Fourier.from_fft(kimage, fft_shape, shape, axes_n)
    if return_fourier:
        return result
    return result.image
