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

Kernel transforms are complex tensors.  :func:`convolve_dft` computes the
same convolution as :func:`convolve_fft` by four matrix products with the
pad, shift and crop folded into the DFT matrices
(:func:`dft_conv_matrices`): the JAX package's ``conv_mode="dft"``, at
its matmul precisions (:data:`PRECISION_PASSES`): float32, or the bf16
tiers on the card's tensor cores (:func:`bf16_matmul`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.fft import next_fast_len

__all__ = [
    "centered",
    "zero_pad",
    "fast_zero_pad",
    "good_fft_shape",
    "good_fft_shape_even",
    "minimal_even_fft_shape",
    "minimal_same_fft_shape",
    "transform",
    "inverse_transform",
    "Fourier",
    "convolve",
    "convolve_fft",
    "dft_conv_matrices",
    "DftOperators",
    "DftTierOperators",
    "PRECISION_PASSES",
    "bf16_split",
    "bf16_matmul",
    "dft_conv_operators",
    "convolve_dft",
    "match_psf",
    "mk_shifter",
    "shift",
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


def dft_conv_matrices(in_shape, fft_shape, dtype=np.float32):
    """Folded matmul-DFT operators for :func:`convolve_dft` (host numpy,
    cached per shape and dtype): four (re, im) stacks ``A`` (2, Hf, Hs),
    ``B`` (2, Ws, Wh), ``iA`` (2, Hs, Hf), ``iB`` (2, Wh, Ws) with
    ``Y = A @ X @ B`` equal to :func:`transform` of ``X`` (zero pad,
    ifftshift, rfft2) and ``Re(iA @ (Y K) @ iB)`` to
    :func:`inverse_transform` (irfft2, fftshift, center crop back to
    ``in_shape``).  The pad, shift and crop index maps are folded into the
    matrices, so the products touch only the ``in_shape`` pixels.
    Ref: scarlet_tpu/ops/fft.py:312-366 (the same arrays)."""
    from ..cache import Cache

    Hs, Ws = int(in_shape[0]), int(in_shape[1])
    Hf, Wf = int(fft_shape[0]), int(fft_shape[1])
    key = (Hs, Ws, Hf, Wf, str(np.dtype(dtype)))
    try:
        return Cache.check("dft_conv_matrices", key)
    except KeyError:
        pass
    cdtype = np.complex128 if np.dtype(dtype) == np.float64 else np.complex64
    Wh = Wf // 2 + 1
    f_y = np.arange(Hf)
    f_x = np.arange(Wh)

    # forward: input row r sits at padded index r + left, then ifftshift
    # rolls by -(Hf//2)
    left_y = (Hf - Hs + 1) // 2
    col_y = (np.arange(Hs) + left_y - Hf // 2) % Hf
    A = np.exp(-2j * np.pi * np.outer(f_y, col_y) / Hf)          # (Hf, Hs)
    left_x = (Wf - Ws + 1) // 2
    col_x = (np.arange(Ws) + left_x - Wf // 2) % Wf
    B = np.exp(-2j * np.pi * np.outer(col_x, f_x) / Wf)          # (Ws, Wh)

    # inverse: output pixel i reads shifted index start + i, i.e. raw
    # index (start + i - n//2) % n; hermitian weights double the
    # non-endpoint rfft bins
    start_y = (Hf - Hs + 1) // 2
    row_y = (np.arange(Hs) + start_y - Hf // 2) % Hf
    iA = np.exp(2j * np.pi * np.outer(row_y, f_y) / Hf) / Hf     # (Hs, Hf)
    start_x = (Wf - Ws + 1) // 2
    row_x = (np.arange(Ws) + start_x - Wf // 2) % Wf
    wgt = np.full(Wh, 2.0)
    wgt[0] = 1.0
    if Wf % 2 == 0:
        wgt[-1] = 1.0
    iB = (np.exp(2j * np.pi * np.outer(f_x, row_x) / Wf)
          * wgt[:, None]) / Wf                                   # (Wh, Ws)

    def split(m):
        return np.stack([m.real, m.imag]).astype(dtype)

    out = tuple(split(m.astype(cdtype)) for m in (A, B, iA, iB))
    Cache.set("dft_conv_matrices", key, out)
    return out


class DftOperators(NamedTuple):
    """:func:`dft_conv_matrices` on a device for :func:`convolve_dft`:
    complex ``A``, ``B``, ``iA``, and ``iB_il`` (2 Wh, Ws), the rows
    Re iB[j] and -Im iB[j] interleaved, so that ``Re(Q @ iB)`` is the real
    product of Q's interleaved (re, im) view with it."""
    A: torch.Tensor
    B: torch.Tensor
    iA: torch.Tensor
    iB_il: torch.Tensor


class DftTierOperators(NamedTuple):
    """:func:`dft_conv_matrices` as the real right operands of the four
    products of :func:`convolve_dft` at a bf16 tier, each already split
    by :func:`bf16_split` (bfloat16): ``B`` of [Re B | Im B] (Ws, 2 Wh),
    ``A`` of [[Re A^T, Im A^T], [-Im A^T, Re A^T]] (2 Hs, 2 Hf), ``iA``
    of the same block of iA^T (2 Hf, 2 Hs) and ``iB`` of
    [Re iB; -Im iB] (2 Wh, Ws); ``passes`` is 1 or 3."""
    B: torch.Tensor
    A: torch.Tensor
    iA: torch.Tensor
    iB: torch.Tensor
    passes: int


# the JAX package's ``conv_precision`` names (those ``jax.lax.Precision``
# takes) -> bf16 passes of each product of the DFT convolution, 0 for
# float32.  Each tier means what it meant on the TPU where it was measured
# (scarlet_tpu/ops/fft.py:378-384), not TF32 on the card: "default" one
# pass of bf16 operands, "high" XLA's bf16_3x
PRECISION_PASSES = {"float32": 0, "highest": 0, "high": 3,
                    "tensorfloat32": 3, "default": 1, "bfloat16": 1,
                    "fastest": 1}


def bf16_split(x, passes, left):
    """The bfloat16 operands of a product at ``passes`` (1 or 3) bf16
    passes: ``hi = bf16(x)``, rounded to nearest even, and for 3 passes
    also ``lo = bf16(x - hi)``, concatenated along the contracted axis
    as (hi, lo, hi) for the left operand (last axis) and (lo, hi, hi) for
    the right one (first axis), so that one product over the tripled
    depth sums hi lo' + lo hi' + hi hi'."""
    hi = x.to(torch.bfloat16)
    if passes == 1:
        return hi
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    if left:
        return torch.cat((hi, lo, hi), dim=-1)
    return torch.cat((lo, hi, hi), dim=-2)


def bf16_matmul(a, b, passes):
    """``a @ b`` at a bf16 tier: ``a`` float32 (M, K), ``b`` the right
    operand already split by :func:`bf16_split` (passes K, N) bfloat16.
    Every product of two bf16 values is exact in float32, and the sums
    run in float32 along the concatenated depth (the hi lo' terms, then
    lo hi', then hi hi' for 3 passes), with a float32 result.  On the
    card one tensor-core product with a float32 output
    (``torch.mm(..., out_dtype=torch.float32)``: bf16 operands, float32
    accumulation; a bf16 ``torch.mm`` would round its output to bf16); on
    the CPU, its plain version, the same operands in float32 through a
    float32 product (only the order of the float32 sums differs)."""
    a = bf16_split(a, passes, left=True)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def dft_conv_operators(in_shape, fft_shape, dtype, device,
                       precision="float32"):
    """The operators of :func:`convolve_dft` at ``precision`` (a name of
    :data:`PRECISION_PASSES`, else ``ValueError``) on ``device``, built
    and uploaded once per (shapes, dtype, precision, device) and shared
    by every caller: :class:`DftOperators` of :func:`dft_conv_matrices`
    at float32, :class:`DftTierOperators` (float32 matrices) at a bf16
    tier."""
    from ..cache import Cache

    if precision not in PRECISION_PASSES:
        raise ValueError(f"DFT convolution precision {precision!r}: one of "
                         f"{tuple(PRECISION_PASSES)}")
    passes = PRECISION_PASSES[precision]
    key = (tuple(in_shape), tuple(fft_shape),
           torch.float32 if passes else dtype, passes, torch.device(device))
    try:
        return Cache.check("dft_conv_operators", key)
    except KeyError:
        pass
    A, B, iA, iB = dft_conv_matrices(
        in_shape, fft_shape,
        np.float32 if passes else torch.empty(0, dtype=dtype).numpy().dtype)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if passes:
        def right(m):
            return bf16_split(torch.from_numpy(np.ascontiguousarray(m)),
                              passes, left=False).to(device)

        out = DftTierOperators(
            right(np.concatenate([B[0], B[1]], 1)),
            right(np.block([[A[0].T, A[1].T], [-A[1].T, A[0].T]])),
            right(np.block([[iA[0].T, iA[1].T], [-iA[1].T, iA[0].T]])),
            right(np.concatenate([iB[0], -iB[1]], 0)), passes)
    else:
        out = DftOperators(
            *(torch.complex(up(m[0]), up(m[1])) for m in (A, B, iA)),
            up(np.stack([iB[0], -iB[1]], 1).reshape(-1, iB.shape[-1])))
    Cache.set("dft_conv_operators", key, out)
    return out


def convolve_dft(image, kernel_rfft, ops):
    """Centered convolution by the folded matmul DFT: ``Y = (A @ X) @ B``,
    then ``Re((iA @ (Y K)) @ iB)`` (:func:`dft_conv_matrices`, ``ops`` from
    :func:`dft_conv_operators`); leading batch axes broadcast.  The same
    function as :func:`convolve_fft` with ``real_shape == image.shape``.
    Ref: scarlet_tpu/ops/fft.py:369-392, at the precision of ``ops``.

    At float32 (:class:`DftOperators`) each product runs in that fixed
    order, complex64, the last one as the real product of the interleaved
    (re, im) view of ``iA @ (Y K)`` with ``iB_il`` (the real part alone,
    contiguous), to float32 roundoff; the products run in float32 (TF32
    stays off on the card: ``lite.engine.pin_float32``, which governs
    complex products too).

    At a bf16 tier (:class:`DftTierOperators`) the complex products are
    real products of the (re, im) parts, four in all, each one
    :func:`bf16_matmul` at the tier, with float32 results between them:
    ``U = X [Re B | Im B]``, then ``Y^T = (A U)^T`` as
    [Re U^T | Im U^T] times the real block of A^T, ``Z^T = Y^T K^T`` in
    float32 complex arithmetic, ``Q^T = (iA Z)^T`` the same way, and
    ``Re(Q iB)`` as [Re Q | Im Q] times [Re iB; -Im iB].  Each product's
    left operand is rounded to bf16 there (``bf16_split``), as XLA
    rounds the operands of each dot at that precision."""
    if isinstance(ops, DftTierOperators):
        return _convolve_dft_bf16(image, kernel_rfft, ops)
    y = torch.matmul(torch.matmul(ops.A, image.to(ops.A.dtype)), ops.B)
    q = torch.matmul(ops.iA, y * kernel_rfft)              # (..., Hs, Wh)
    return torch.matmul(torch.view_as_real(q).flatten(-2), ops.iB_il)


def _convolve_dft_bf16(image, kernel_rfft, ops):
    """:func:`convolve_dft` at a bf16 tier (its docstring)."""
    Hs, Ws = image.shape[-2:]
    Wh, Hf = ops.B.shape[-1] // 2, ops.A.shape[-1] // 2

    def mm(a, b):
        return bf16_matmul(a, b, ops.passes)

    # rows (n, h): [Re U | Im U]; then rows (n, w): [Re U^T | Im U^T]
    u = mm(image.to(torch.float32).reshape(-1, Ws), ops.B)
    v = u.view(-1, Hs, 2, Wh).permute(0, 3, 2, 1).reshape(-1, 2 * Hs)
    yt = mm(v, ops.A).view(*image.shape[:-2], Wh, 2, Hf)
    yr, yi = yt.unbind(-2)
    kt = kernel_rfft.transpose(-2, -1)
    kr, ki = kt.real, kt.imag
    zt = torch.stack((yr * kr - yi * ki, yr * ki + yi * kr), dim=-2)
    lead = zt.shape[:-3]
    # rows (n, w): [Re Q^T | Im Q^T]; then rows (n, h): [Re Q | Im Q]
    qt = mm(zt.reshape(-1, 2 * Hf), ops.iA)
    q = qt.view(-1, Wh, 2, Hs).permute(0, 3, 2, 1).reshape(-1, 2 * Wh)
    return mm(q, ops.iB).view(*lead, Hs, Ws)


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


def mk_shifter(shape, real=False, device=None):
    """Fourier-domain shift phase gradients ``(-2*pi*i*freq_y,
    -2*pi*i*freq_x)`` of an FFT ``shape``, complex128 (on ``device``, the
    CPU by default); ``real``: rFFT frequencies on both axes.
    Ref: scarlet/interpolation.py:341-375."""
    freq_x = np.fft.rfftfreq(shape[-1])
    freq_y = np.fft.rfftfreq(shape[-2]) if real else np.fft.fftfreq(shape[-2])
    return tuple(torch.from_numpy(-1j * 2 * np.pi * f).to(device)
                 for f in (freq_y, freq_x))


def shift(image, shift_yx, fft_shape=None, axes=(-2, -1),
          return_fourier=True):
    """Sub-pixel shift of ``image`` by ``(dy, dx)`` through Fourier
    phasors.  The phasors are complex128, so the product and the result
    promote to float64 (as the JAX package's do with 64-bit mode on).
    ``shift_yx`` may be a tensor (autograd flows through it).
    Ref: scarlet/fft.py:399-428."""
    image = _as_fourier(image)
    if fft_shape is None:
        fft_shape = good_fft_shape(image.image, image.image, padding=10,
                                   axes=axes)
    axes_n = _normalize_axes(image.image.ndim, axes)
    image_fft = image.fft(fft_shape, axes_n)
    shifter_y, shifter_x = mk_shifter(fft_shape, device=image_fft.device)
    shift_yx = torch.as_tensor(shift_yx, device=image_fft.device)
    shifter = (torch.exp(shifter_y[:, None] * shift_yx[0])
               * torch.exp(shifter_x[None, :] * shift_yx[1]))
    ndim = image.image.ndim
    # the phasor over the transformed axes, unit dims elsewhere
    view = [1] * ndim
    view[axes_n[0]], view[axes_n[1]] = shifter.shape
    result_fft = image_fft * shifter.reshape(view)
    result = Fourier.from_fft(result_fft, fft_shape, image.shape, axes_n)
    if return_fourier:
        return result
    return result.image
