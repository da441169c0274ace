"""Starlet (isotropic undecimated) wavelet transform and the ground-type
multiresolution support, batched over leading axes: the part of
``scarlet_tpu/ops/wavelet.py`` that device detection and the wavelet
initialization run, and the host support of the wavelet init's host
path (:func:`get_multiresolution_support`).

The a-trous B3-spline convolution is five zero-boundary shift-adds per
axis, in the JAX package's order, so each coefficient is the same sum of
the same float32 products on every device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "shift_axis",
    "bspline_convolve",
    "get_scales",
    "starlet_transform",
    "multiresolution_support",
    "get_multiresolution_support",
]

# B3 spline filter (Starck et al. 2011; scarlet/wavelet.py:171)
_H1D = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def shift_axis(x, k, axis):
    """``out[i] = x[i - k]`` along ``axis`` (toward larger indices for
    ``k > 0``), zero-filled; integer ``k``.  Port of
    ``scarlet_tpu/ops/arrays.shift_axis``."""
    if k == 0:
        return x
    n = x.shape[axis]
    if abs(k) >= n:
        return torch.zeros_like(x)
    zshape = list(x.shape)
    zshape[axis] = abs(k)
    zeros = x.new_zeros(zshape)
    if k > 0:
        return torch.cat([zeros, x.narrow(axis, 0, n - k)], dim=axis)
    return torch.cat([x.narrow(axis, -k, n + k), zeros], dim=axis)


def bspline_convolve(image, scale):
    """Separable a-trous B3-spline convolution of ``image`` (..., H, W) at
    ``scale`` (tap spacing ``2**scale``), zero boundary
    (scarlet_tpu/ops/wavelet.py:36-55)."""
    j = int(scale)
    s1, s2 = 2 ** j, 2 ** (j + 1)
    h0, h1, h2, h3, h4 = _H1D

    col = image * h2
    col = col + shift_axis(image, s2, -2) * h0
    col = col + shift_axis(image, s1, -2) * h1
    col = col + shift_axis(image, -s1, -2) * h3
    col = col + shift_axis(image, -s2, -2) * h4

    result = col * h2
    result = result + shift_axis(col, s2, -1) * h0
    result = result + shift_axis(col, s1, -1) * h1
    result = result + shift_axis(col, -s1, -1) * h3
    result = result + shift_axis(col, -s2, -1) * h4
    return result


def get_scales(image_shape, scales=None):
    """Default and maximum number of starlet scales for an image of
    ``image_shape`` (scarlet_tpu/ops/wavelet.py:58)."""
    max_scale = int(np.log2(np.min(image_shape[-2:]))) - 1
    if scales is None or scales > max_scale:
        scales = max_scale
    return int(scales)


def starlet_transform(image, scales=None):
    """Second-generation starlet coefficients of ``image`` (..., H, W):
    (..., scales + 1, H, W), the last plane the coarse residual
    (scarlet_tpu/ops/wavelet.py:66-88)."""
    scales = get_scales(image.shape, scales)
    c = image
    coeffs = []
    for j in range(scales):
        gen1 = bspline_convolve(c, j)
        coeffs.append(c - bspline_convolve(gen1, j))
        c = gen1
    coeffs.append(c)
    return torch.stack(coeffs, dim=-3)


def multiresolution_support(starlets, sigma, K=3, epsilon=1e-1, max_iter=20,
                            valid=None):
    """Ground-type significance masks of starlet coefficients, batched:
    the port of ``multiresolution_support_jax``
    (scarlet_tpu/ops/wavelet.py:254-312).

    starlets (..., J, H, W); sigma: the noise level, a float or a tensor
    of the leading shape; valid: optional (..., H, W) mask of real pixels
    (the per-scale std then runs over them only).  Per blend, iterate
    ``sigma_j <- std(c_j where |c_j| <= K sigma_j)`` until every scale
    with ``sigma_j > 0`` moves by less than ``epsilon`` relative, or
    ``max_iter`` times; the mask ``|c| > K sigma`` uses the sigma of the
    blend's last executed iteration.

    Under ``vmap`` the JAX loop keeps a converged blend's carry while the
    others run on.  Here every blend runs ``max_iter`` iterations with a
    converged blend's ``(sigma, sigma_last)`` frozen, which gives the same
    masks and reads nothing back from the device.  The std's sums
    accumulate in float64 and round to float32, so the CPU and the card
    take the same threshold decisions (float32 sums in their two orders
    part at roundoff).

    Returns the (..., J, H, W) int32 mask.
    """
    lead = starlets.shape[:-3]
    J, H, W = starlets.shape[-3:]
    c = starlets.reshape(-1, J, H, W)
    B = c.shape[0]
    dtype, dev = c.dtype, c.device
    if valid is None:
        validb = torch.ones((B, 1, H, W), dtype=torch.bool, device=dev)
    else:
        validb = (valid.reshape(B, 1, H, W) > 0)
    n_valid = torch.clamp_min(validb.sum(dim=(-2, -1), dtype=torch.int64),
                              1).to(torch.float64)              # (B, 1)
    tiny = torch.finfo(dtype).tiny

    def masked_std(x):
        mean = (torch.where(validb, x, 0.0).sum(
            dim=(-2, -1), dtype=torch.float64) / n_valid).to(dtype)
        d = x - mean[..., None, None]
        var = (torch.where(validb, d * d, 0.0).sum(
            dim=(-2, -1), dtype=torch.float64) / n_valid).to(dtype)
        return torch.sqrt(var)

    sigma = torch.as_tensor(sigma, dtype=dtype, device=dev)
    sig = sigma.reshape(-1, 1).expand(B, J).clone() if sigma.ndim \
        else torch.full((B, J), float(sigma), dtype=dtype, device=dev)
    sig_last = sig
    done = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    absc = c.abs()
    for _ in range(max_iter):
        keep = ~(absc > K * sig[..., None, None]) & validb
        nxt = masked_std(torch.where(keep, c, 0.0))
        conv = torch.where(nxt > 0, (nxt - sig).abs()
                           / torch.clamp_min(nxt, tiny) < epsilon,
                           True).all(dim=-1, keepdim=True)
        sig_last = torch.where(done, sig_last, sig)
        sig = torch.where(done, sig, nxt)
        done = done | conv
    mask = absc > K * sig_last[..., None, None]
    return mask.to(torch.int32).reshape(*lead, J, H, W)


def get_multiresolution_support(image, starlets, sigma, K=3, epsilon=1e-1,
                                max_iter=20, image_type="ground"):
    """Significance masks (K-sigma clipping per scale) of host (numpy)
    starlet coefficients: (J, H, W) int.  Host side, the ground variant of
    scarlet_tpu/ops/wavelet.py:211-251, in its numpy arithmetic (the std
    of the float32 coefficients times the int mask, the loop's early
    exit), so the host path decides like the JAX package's.  The "space"
    variant draws unseeded noise and is not ported."""
    if image_type != "ground":
        raise NotImplementedError(
            f"get_multiresolution_support: image_type {image_type!r} is not "
            "ported; only 'ground' is")
    image = np.asarray(image)
    starlets = np.asarray(starlets)
    sigma_j = np.ones((len(starlets),), dtype=image.dtype) * sigma
    last_sigma_j = sigma_j
    for _ in range(max_iter):
        M = np.abs(starlets) > K * sigma_j[:, None, None]
        S = ~M
        sigma_j = np.std(starlets * S.astype(int), axis=(1, 2))
        cut = sigma_j > 0
        if np.all(np.abs(sigma_j[cut] - last_sigma_j[cut]) / sigma_j[cut]
                  < epsilon):
            break
        last_sigma_j = sigma_j
    return M.astype(int)
