"""Frozen copy of the port's FFT helpers (``ops/fft.py``): shapes,
transforms and the FFT convolution, verbatim."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.fft import next_fast_len


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


def _pad(arr, widths):
    """``F.pad`` by per-axis (before, after) ``widths`` in numpy order
    (``F.pad`` takes the last axis first)."""
    flat = []
    for lo, hi in reversed(widths):
        flat.extend((int(lo), int(hi)))
    return F.pad(arr, flat)


def fast_zero_pad(arr, pad_width):
    """Zero-pad with explicit per-axis (before, after) widths, one pair
    per axis of ``arr`` as ``np.pad`` takes them; a negative width raises,
    as in ``jnp.pad`` (``F.pad`` would crop).
    Ref: scarlet_tpu/ops/fft.py:83-85."""
    if len(pad_width) != arr.ndim:
        raise ValueError(f"pad_width has {len(pad_width)} pairs for an "
                         f"array of {arr.ndim} axes")
    if any(w < 0 for pair in pad_width for w in pair):
        raise ValueError(f"negative pad width in {pad_width}")
    return _pad(arr, pad_width)


def zero_pad(arr, newshape, axes=None):
    """Zero-pad ``arr`` to ``newshape`` (inverse of :func:`centered`); a
    ``newshape`` smaller than ``arr`` raises, as ``jnp.pad`` does (a
    negative ``F.pad`` width would crop instead).
    Ref: scarlet/fft.py:82-113."""
    axes = _normalize_axes(arr.ndim, axes)
    if len(newshape) == arr.ndim and len(axes) != arr.ndim:
        newshape = [newshape[a] for a in axes]
    widths = [(0, 0)] * arr.ndim
    for a, new in zip(axes, newshape):
        ds = new - arr.shape[a]
        if ds < 0:
            raise ValueError(
                f"arr must be smaller than newshape, got {tuple(arr.shape)} "
                f"-> {tuple(newshape)}")
        left = (ds + 1) // 2
        widths[a] = (left, ds - left)
    return _pad(arr, widths)


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


def convolve_fft(image, kernel_rfft, fft_shape, axes=(-2, -1),
                 real_shape=None):
    """Convolution with a precomputed kernel rFFT (complex tensor at
    ``fft_shape``); leading axes broadcast."""
    if real_shape is None:
        real_shape = tuple(image.shape)
    kimage = transform(image, fft_shape, axes)
    return inverse_transform(kimage * kernel_rfft, fft_shape, real_shape,
                             axes)
