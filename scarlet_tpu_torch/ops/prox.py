"""Proximal operators: those of the lite fit and its initialization, and
the rest of ``scarlet_tpu/ops/prox.py`` that the object tree's
constraints use.

The radial monotonicity projection is computed as an exact Jacobi
fixed-point iteration (:func:`prox_weighted_monotonic`): a pixel's
reference neighbors are strictly closer to the peak, so the dependency
graph is a DAG and ``monotonic_depth`` parallel passes reproduce the
reference's sequential radius-ordered sweep (operators_pybind11.cc:14-36).
:func:`build_prox_monotonic` runs it through ``kernels.monotonic_prox``
at tolerance 0: the Hopper kernel K1 on the card, its plain version on
the CPU.

The weight tables and the DAG depth are host-side numpy; the projection
itself and the symmetry operators work on torch tensors.  The monotonic
mask (the pixels reachable monotonically from the peak) of one host
image, :func:`prox_monotonic_mask`, and the sequential sweep,
:func:`prox_weighted_monotonic_seq`, run in the host C library
(:mod:`scarlet_tpu_torch.native`), as in the JAX package; the mask of a
batch on the device is a closure on tensors, :func:`monotonic_mask_device`.
The cone and the disk-SED projections are host numpy.

Behavioral references: scarlet/operator.py, scarlet/operators_pybind11.cc,
proxmin.operators (prox_hard/prox_soft/prox_unity_plus).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "NEIGHBOR_OFFSETS",
    "prox_plus",
    "prox_hard",
    "prox_hard_plus",
    "prox_soft",
    "prox_soft_plus",
    "prox_unity",
    "prox_unity_plus",
    "threshold",
    "prox_threshold",
    "sort_by_radius",
    "monotonic_weights",
    "monotonic_depth",
    "monotonic_tables",
    "device_tables",
    "shared_tensors",
    "shift_zero",
    "prox_weighted_monotonic",
    "build_prox_monotonic",
    "prox_sdss_symmetry",
    "prox_soft_symmetry",
    "prox_kspace_symmetry",
    "uncentered_operator",
    "prox_uncentered_symmetry",
    "get_center",
    "MASK_PASSES",
    "mask_counts",
    "reset_mask_counts",
    "mask_extent",
    "prox_monotonic_mask",
    "monotonic_mask_device",
    "prox_cone",
    "project_disk_sed",
    "project_disk_sed_mean",
    "proximal_disk_sed",
    "getOffsets",
    "diagonalizeArray",
    "getRadialMonotonicWeights",
    "prox_weighted_monotonic_seq",
]

# 8-neighbor offsets in the reference's order (operator.py:84).
NEIGHBOR_OFFSETS = (
    (-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1),
)


# ---------------------------------------------------------------------------
# Elementary proxes (proxmin.operators equivalents)
# ---------------------------------------------------------------------------
def prox_plus(X, step=0):
    """Projection onto the non-negative orthant."""
    return torch.clamp_min(X, 0)


def _thresh_value(step, thresh, type):
    assert type in ("relative", "absolute")
    return thresh * step if type == "relative" else thresh


def prox_hard(X, step, thresh=0, type="absolute"):
    """Hard thresholding: zero out ``|X| < thresh``."""
    t = _thresh_value(step, thresh, type)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t), device=X.device)
    return torch.where(torch.abs(X) < t, 0.0, X)


def prox_hard_plus(X, step, thresh=0, type="absolute"):
    """Hard thresholding followed by positivity."""
    return prox_plus(prox_hard(X, step, thresh=thresh, type=type))


def prox_soft(X, step, thresh=0, type="absolute"):
    """Soft thresholding: shrink towards zero by ``thresh``."""
    t = _thresh_value(step, thresh, type)
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t), device=X.device)
    return torch.sign(X) * torch.clamp_min(torch.abs(X) - t, 0)


def prox_soft_plus(X, step, thresh=0, type="absolute"):
    return torch.clamp_min(prox_soft(X, step, thresh=thresh, type=type), 0)


def prox_unity(X, step=0, axis=None):
    """Normalize so the sum along ``axis`` is one."""
    if axis is None:
        return X / X.sum()
    return X / X.sum(dim=axis, keepdim=True)


def prox_unity_plus(X, step=0, axis=None):
    return prox_unity(prox_plus(X), step, axis=axis)


# ---------------------------------------------------------------------------
# Noise-threshold prox (log-histogram cutoff)
# ---------------------------------------------------------------------------
def threshold(morph):
    """Noise cutoff from the log10 histogram of positive pixels (host
    numpy).  Ref: scarlet/constraint.py:165-180.  Returns (thresh, bins).
    """
    if isinstance(morph, torch.Tensor):
        morph = morph.detach().cpu().numpy()
    morph = np.asarray(morph)
    _morph = morph[morph > 0]
    _bins = 50
    if _morph.size < 500:
        _bins = max(int(_morph.size / 10), 1)
        if _bins == 1:
            return 0, _bins
    hist, bins = np.histogram(np.log10(_morph).reshape(-1), _bins)
    cutoff = np.where(hist == 0)[0]
    if len(cutoff) == 0:
        return 0, _bins
    return 10 ** bins[cutoff[-1]], _bins


def prox_threshold(X, step=0):
    """:func:`threshold` + hard-plus prox on the tensor's device, with no
    host read: the bin of each pixel is computed arithmetically, so the
    data-dependent bin count needs no dynamic shapes (the JAX package's
    jit form, scarlet_tpu/ops/prox.py:128-159)."""
    pos = X > 0
    n = pos.sum()
    logX = torch.where(pos, torch.log10(torch.where(pos, X, 1.0)), 0.0)
    lo = torch.where(pos, logX, float("inf")).min()
    hi = torch.where(pos, logX, float("-inf")).max()

    max_bins = 50
    nb = torch.where(n < 500, torch.clamp(n // 10, 1, max_bins), max_bins)
    nbf = nb.to(X.dtype)

    width = torch.where(hi > lo, hi - lo, 1.0)
    idx = torch.minimum(torch.clamp_min(torch.floor((logX - lo) / width
                                                    * nbf), 0),
                        nbf - 1).long()
    counts = torch.zeros(max_bins, dtype=torch.int64, device=X.device)
    counts.scatter_add_(0, torch.where(pos, idx, max_bins - 1).reshape(-1),
                        pos.reshape(-1).long())
    # last empty bin among bins [0, nb)
    bin_ids = torch.arange(max_bins, device=X.device)
    empty = (counts == 0) & (bin_ids < nb)
    cutoff = torch.where(empty, bin_ids, -1).max()
    thresh_val = 10 ** (lo + cutoff.to(X.dtype) * width / nbf)
    thresh = torch.where((cutoff < 0) | (nb <= 1) | (n == 0), 0.0,
                         thresh_val)
    return prox_hard_plus(X, step, thresh=thresh, type="absolute")


def sort_by_radius(shape, center=None):
    """Flat pixel indices sorted by distance from ``center``.

    Ref: scarlet/operator.py:10-48.
    """
    if center is None:
        cx = (shape[1] - 1) >> 1
        cy = (shape[0] - 1) >> 1
    else:
        cy, cx = int(center[0]), int(center[1])
    X, Y = np.meshgrid(np.arange(shape[1]) - cx, np.arange(shape[0]) - cy)
    distance = np.sqrt(X ** 2 + Y ** 2)
    return np.argsort(distance.flatten())


def monotonic_weights(shape, neighbor_weight="flat", center=None):
    """(8, H, W) float64 neighbor weights for the radial monotonicity
    projection: for each pixel, weights over its 8 neighbors that are
    strictly closer to ``center``; 'angle' weighs by the cosine between
    the pixel->center and pixel->neighbor directions, 'flat' equally,
    'nearest' one-hots the best-aligned one.  Normalized to sum to 1 per
    pixel (except 'nearest').  Ref: scarlet/operator.py:591-667.
    """
    assert neighbor_weight in ("flat", "angle", "nearest")
    H, W = shape
    if center is None:
        center = ((H - 1) // 2, (W - 1) // 2)
    py, px = int(center[0]), int(center[1])

    X, Y = np.meshgrid(np.arange(W, dtype=np.float64) - px,
                       np.arange(H, dtype=np.float64) - py)
    distance = np.sqrt(X ** 2 + Y ** 2)
    # angle of the pixel->center direction, with the reference's
    # arctan2(-Y, -X) patched convention (operator.py:618-622)
    angles = np.arctan2(-Y, -np.where(X == 0, 0.0, X))
    on_axis = (X == 0) & (Y != 0)
    angles[on_axis] = 0.5 * np.pi * np.sign(-Y[on_axis])

    weights = np.zeros((8, H, W), dtype=np.float64)
    yy, xx = np.mgrid[0:H, 0:W]
    for d, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        ny, nx = yy + dy, xx + dx
        valid = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
        nyc = np.clip(ny, 0, H - 1)
        nxc = np.clip(nx, 0, W - 1)
        closer = distance - distance[nyc, nxc] > 0
        ok = valid & closer
        rel_angle = np.arctan2(dy, dx)
        w = np.cos(angles - rel_angle)
        weights[d] = np.where(ok, w, 0.0)

    if neighbor_weight == "nearest":
        best = np.argmax(weights, axis=0)
        one_hot = np.zeros_like(weights)
        one_hot[best, yy, xx] = 1.0
        one_hot *= (weights.max(axis=0) > 0)
        one_hot[:, py, px] = 0
        return one_hot

    if neighbor_weight == "flat":
        weights = (weights != 0).astype(np.float64)
    norm = weights.sum(axis=0)
    norm[norm == 0] = 1
    return weights / norm


def monotonic_depth(weights, shape, center):
    """Depth of the monotonicity reference DAG: the exact number of Jacobi
    passes :func:`prox_weighted_monotonic` needs to reproduce the
    sequential sweep."""
    H, W = shape
    w = np.asarray(weights) > 0
    order = sort_by_radius(shape, center)
    depth = np.zeros(H * W, dtype=np.int64)
    for flat in order:
        y, x = divmod(int(flat), W)
        best = -1
        for d, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
            if w[d, y, x]:
                best = max(best, depth[(y + dy) * W + (x + dx)])
        depth[flat] = best + 1
    return int(depth.max())


def shift_zero(x, dy, dx):
    """``out[..., y, x] = x[..., y+dy, x+dx]``, zero outside."""
    H, W = x.shape[-2:]
    padded = F.pad(x, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)))
    y0, x0 = max(0, dy), max(0, dx)
    return padded[..., y0:y0 + H, x0:x0 + W]


def prox_weighted_monotonic(X, weights, n_iter, min_gradient=0.1,
                            center=None):
    """Radially monotonic projection of one (H, W) image.

    Iterates ``X <- min(X0, (sum_d w_d * shift_d(X)) * (1 - min_gradient))``
    from ``X0`` for ``n_iter`` passes; the center pixel is never modified.
    Exact for ``n_iter >= monotonic_depth``.

    weights: (8, H, W) from :func:`monotonic_weights` (numpy or tensor).
    """
    H, W = X.shape[-2:]
    if center is None:
        center = ((H - 1) // 2, (W - 1) // 2)
    cy, cx = int(center[0]), int(center[1])
    keep = torch.zeros((H, W), dtype=torch.bool, device=X.device)
    keep[cy, cx] = True
    w = torch.as_tensor(np.asarray(weights), dtype=X.dtype, device=X.device)
    scale = 1.0 - min_gradient
    X0 = X
    x = X0
    for _ in range(n_iter):
        ref = torch.zeros_like(x)
        for d, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
            ref = ref + w[d] * shift_zero(x, dy, dx)
        x = torch.where(keep, X0, torch.minimum(X0, ref * scale))
    return x


def monotonic_tables(shape, neighbor_weight, centers):
    """The tables ``kernels.monotonic_prox`` reads for one (H, W) box and
    the candidate centers ``centers`` (a list of (y, x)), host numpy:
    weights (ncand, 8, H, W) and keep (ncand, H, W) float64, and the
    number of passes (the largest DAG depth of the candidates: at
    tolerance 0 further passes change nothing).  Memoized."""
    from ..cache import Cache

    centers = tuple((int(cy), int(cx)) for cy, cx in centers)
    key = (tuple(shape), centers, neighbor_weight)
    try:
        return Cache.check("monotonic_tables", key)
    except KeyError:
        pass
    weights, keep, depth = [], [], 0
    for c in centers:
        w = monotonic_weights(shape, neighbor_weight, c)
        weights.append(w)
        k = np.zeros(shape)
        k[c] = 1.0
        keep.append(k)
        depth = max(depth, monotonic_depth(w, shape, c))
    out = (np.stack(weights), np.stack(keep), depth)
    Cache.set("monotonic_tables", key, out)
    return out


def shared_tensors(name, key, arrays, device):
    """``arrays`` (host numpy, or a function that returns them, called on
    the first upload only) on ``device``, uploaded once per (name, key,
    device) and shared by every caller: for read-only tables such as the
    monotonicity tables, whose compact taps the projection kernel then
    builds once (``ops.kernels``), not once per blend, chunk or prox
    call."""
    from ..cache import Cache

    k = (key, str(torch.device(device)))
    try:
        return Cache.check(name, k)
    except KeyError:
        pass
    if callable(arrays):
        arrays = arrays()
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays)
    Cache.set(name, k, out)
    return out


def device_tables(shape, neighbor_weight, centers, device, dtype):
    """:func:`monotonic_tables` on ``device`` in ``dtype``, uploaded once
    (:func:`shared_tensors`): (weights, keep, passes, a (1, 1) int32 index
    of candidate 0)."""
    centers = tuple((int(cy), int(cx)) for cy, cx in centers)
    w, k, depth = monotonic_tables(shape, neighbor_weight, centers)
    wt, kt, idx = shared_tensors(
        f"device_tables_{dtype}", (tuple(shape), centers, neighbor_weight),
        lambda: (w.astype(torch.empty(0, dtype=dtype).numpy().dtype),
                 k.astype(torch.empty(0, dtype=dtype).numpy().dtype),
                 np.zeros((1, 1), np.int32)), device)
    return wt, kt, depth, idx


def build_prox_monotonic(shape, neighbor_weight="flat", min_gradient=0.1,
                         center=None):
    """A monotonicity prox ``f(X, step) -> X`` for one (H, W) shape and
    center: ``kernels.monotonic_prox`` at tolerance 0 with a one-row table
    (K1 on a CUDA tensor, which must be float32; the plain version on the
    CPU, in the tensor's dtype), equal to the JAX package's ``depth``
    Jacobi passes (scarlet_tpu/ops/prox.py:303-333)."""
    from . import kernels

    H, W = shape
    if center is None:
        center = ((H - 1) // 2, (W - 1) // 2)
    c = (int(center[0]), int(center[1]))

    def prox(X, step=0):
        wt, kt, n_iter, idx = device_tables(shape, neighbor_weight, [c],
                                            X.device, X.dtype)
        return kernels.monotonic_prox(X[None, None], idx, wt, kt, n_iter,
                                      min_gradient, tol=0.0)[0, 0]

    return prox


def prox_sdss_symmetry(X, step=0):
    """min(X, 180deg-rotated X). Ref: operator.py:263-271."""
    return torch.minimum(X, torch.flip(X, (-2, -1)))


def prox_soft_symmetry(X, step=0, strength=1):
    """Soft symmetry: blend with the 180deg rotation by ``strength``.
    Even shapes are padded by one so the rotation center is a pixel.
    Ref: operator.py:274-293."""
    H, W = X.shape
    ph, pw = int(H % 2 == 0), int(W % 2 == 0)
    Xp = F.pad(X, (0, pw, 0, ph))
    Xs = torch.flip(Xp, (-2, -1))
    out = 0.5 * strength * (Xp + Xs) + (1 - strength) * Xp
    return out[:H, :W]


def prox_kspace_symmetry(X, step=0, shift=None, padding=10):
    """Symmetrize under a fractional shift by discarding the imaginary
    part in Fourier space.  Ref: operator.py:296-332."""
    from . import fft as fft_ops

    fft_shape = fft_ops.good_fft_shape(X, X, padding=padding)
    dy, dx = shift
    zero_mask = X <= 0

    X_fft = fft_ops.transform(X, fft_shape, (0, 1))
    shifter_y, shifter_x = fft_ops.mk_shifter(fft_shape, device=X.device)

    result_fft = X_fft * torch.exp(shifter_y[:, None] * (-dy))
    result_fft = result_fft * torch.exp(shifter_x[None, :] * (-dx))
    result_fft = result_fft.real.to(X_fft.dtype)
    result_fft = result_fft * torch.exp(shifter_y[:, None] * dy)
    result_fft = result_fft * torch.exp(shifter_x[None, :] * dx)

    result = fft_ops.inverse_transform(result_fft, fft_shape, X.shape,
                                       (0, 1))
    return torch.where(zero_mask, 0.0, result.real)


def uncentered_operator(X, func, center=None, fill=None, **kwargs):
    """Apply ``func`` only on the largest centered sub-window around
    ``center``.  Ref: operator.py:207-260."""
    if center is None:
        flat = int(torch.argmax(X))
        py, px = divmod(flat, X.shape[1])
    else:
        py, px = center
    cy, cx = X.shape[0] // 2, X.shape[1] // 2

    if py == cy and px == cx:
        return func(X, **kwargs)

    dy = int(2 * (py - cy))
    dx = int(2 * (px - cx))
    if not X.shape[0] % 2:
        dy += 1
    if not X.shape[1] % 2:
        dx += 1
    xslice = slice(None, dx) if dx < 0 else slice(dx, None)
    yslice = slice(None, dy) if dy < 0 else slice(dy, None)

    sub = func(X[yslice, xslice], **kwargs)
    if fill is not None:
        out = torch.full_like(X, fill)
    else:
        out = X.clone()
    out[yslice, xslice] = sub
    return out


def prox_uncentered_symmetry(X, step=0, center=None, algorithm="kspace",
                             fill=None, shift=None, strength=0.5):
    """Symmetry about an off-center peak. Ref: operator.py:335-400."""
    if algorithm == "kspace" and (shift is None
                                  or np.all(np.asarray(shift) == 0)):
        algorithm = "soft"
        strength = 1
    if algorithm == "kspace":
        return uncentered_operator(X, prox_kspace_symmetry, center,
                                   shift=shift, step=step, fill=fill)
    if algorithm == "sdss":
        return uncentered_operator(X, prox_sdss_symmetry, center, step=step,
                                   fill=fill)
    if algorithm == "soft":
        return uncentered_operator(X, prox_soft_symmetry, center, step=step,
                                   strength=strength, fill=fill)
    raise ValueError("algorithm must be one of 'soft', 'sdss', 'kspace', "
                     f"received '{algorithm}'")


# ---------------------------------------------------------------------------
# Monotonic mask: the pixels reachable monotonically from the peak
# ---------------------------------------------------------------------------
# closure passes between two host reads of "did any pixel join"
MASK_PASSES = 8

# closure passes and host reads of monotonic_mask_device since the last
# reset_mask_counts()
_mask_counts = {"passes": 0, "host_syncs": 0}


def mask_counts():
    """Closure passes and host reads of :func:`monotonic_mask_device`
    since the last :func:`reset_mask_counts` (a copy)."""
    return dict(_mask_counts)


def reset_mask_counts():
    for k in _mask_counts:
        _mask_counts[k] = 0


def mask_extent(on):
    """Bounds of each (..., H, W) mask's pixels: (y0, y1, x0, x1) tensors,
    H, -1, W, -1 where a mask is empty."""
    H, W = on.shape[-2:]
    ry = torch.arange(H, device=on.device)
    rx = torch.arange(W, device=on.device)
    row_on = on.any(dim=-1)
    col_on = on.any(dim=-2)
    return (torch.where(row_on, ry, H).amin(dim=-1),
            torch.where(row_on, ry, -1).amax(dim=-1),
            torch.where(col_on, rx, W).amin(dim=-1),
            torch.where(col_on, rx, -1).amax(dim=-1))


def prox_monotonic_mask(X, step=0, center=None, center_radius=1,
                        variance=0.0, max_iter=3):
    """Keep only the pixels reachable monotonically from the peak near
    ``center``; returns ``(valid, model, bounds)`` (numpy, host side).
    Ref: scarlet/operator.py:132-180; scarlet_tpu/ops/prox.py:476-511.

    The peak is :func:`get_center`'s (the first maximum of the (2r+1)^2
    window, or the rounded center with ``center_radius=0``).  The host C
    library's flood fill (:func:`..native.get_valid_monotonic_pixels`)
    runs on the image's float32 values; with ``max_iter > 0`` the orphans
    (pixels next to the mask that failed to join) are filled from their
    neighbours' gradients and the fill continues from them, up to
    ``max_iter`` rounds (:func:`..native.linear_interpolate_invalid_pixels`,
    operators_pybind11.cc:127-232).  ``bounds`` (min y, max y, min x, max
    x) is the mask's extent, and the model the float32 image times the
    mask, cast back to the image's dtype.  :func:`monotonic_mask_device`
    computes the same mask (``max_iter=0``) for a batch of tensors."""
    from .. import native

    X = np.asarray(X)
    if center is None:
        center = (X.shape[0] // 2, X.shape[1] // 2)
    if center_radius > 0:
        i, j = get_center(X, center, center_radius)
    else:
        i, j = int(np.round(center[0])), int(np.round(center[1]))
    i, j = int(i), int(j)
    unchecked = np.ones(X.shape, dtype=np.uint8)
    unchecked[i, j] = 0
    orphans = np.zeros(X.shape, dtype=np.uint8)
    bounds = np.array([i, i, j, j], dtype=np.int32)
    X32 = np.ascontiguousarray(X, np.float32)
    native.get_valid_monotonic_pixels(X32, i, j, unchecked, orphans,
                                      variance, bounds)
    model = X32.copy()
    it = 0
    # the masks hold 0 or 1: "any unchecked orphan" is (orphans &
    # unchecked).any(), the reference's np.sum(orphans & unchecked) > 0
    while it < max_iter and (orphans & unchecked).any():
        it += 1
        all_i, all_j = np.nonzero(orphans)
        native.linear_interpolate_invalid_pixels(
            all_i, all_j, unchecked, model, orphans, variance, True, bounds)
    valid = (unchecked == 0) & (orphans == 0)
    return valid, (model * valid).astype(X.dtype), bounds


def get_center(image, center, radius=1):
    """The peak pixel of the (2r+1)^2 window around ``center`` (clipped
    at the low edge; the first maximum).  Ref: scarlet/operator.py:99-129.
    """
    image = np.asarray(image)
    cy, cx = int(center[0]), int(center[1])
    y0 = max(cy - radius, 0)
    x0 = max(cx - radius, 0)
    subset = image[y0:cy + radius + 1, x0:cx + radius + 1]
    c = np.unravel_index(np.argmax(subset), subset.shape)
    return c[0] + y0, c[1] + x0


def monotonic_mask_device(X, centers, center_radius=1, variance=0.0):
    """The monotonic mask of :func:`prox_monotonic_mask` (``max_iter=0``)
    for a batch, on the tensors' device: X (..., H, W), centers (..., 2)
    integer (y, x).  Port of scarlet_tpu/ops/prox.py:414-473.

    The peak is searched in the (2r+1)^2 window about each center, which
    is clipped at the low edge and masked past the high edge; the first
    maximum wins.  A pixel joins when a 4-neighbour has joined, it is
    below that neighbour plus ``variance``, and it is positive: which
    pixels join depends only on the original values, so the set is the
    closure of these steps, whatever their order (the set the reference's
    host flood fill finds).  Passes run in blocks of :data:`MASK_PASSES`
    and the host reads "did any pixel of the batch join" once per block
    (a pass after the closure changes nothing); :func:`mask_counts`
    counts them.  The call is a ``torch.profiler`` range of its own name.

    Returns ``(valid, model)``: the (..., H, W) bool mask and X where
    valid, +0 elsewhere (XLA's select, where
    :func:`prox_monotonic_mask`'s product keeps the sign of a negative
    pixel's zero)."""
    with torch.profiler.record_function("monotonic_mask_device"):
        return _mask_closure(X, centers, center_radius, variance)


def _mask_closure(X, centers, center_radius, variance):
    lead = X.shape[:-2]
    H, W = X.shape[-2:]
    x = X.reshape(-1, H, W)
    N = x.shape[0]
    dev = x.device
    c = torch.as_tensor(centers, device=dev).reshape(N, 2).long()
    cy, cx = c[:, 0], c[:, 1]
    if center_radius > 0:
        r = int(center_radius)
        n = 2 * r + 1
        # the window's top-left, clipped at the low edge and kept inside
        # the image padded by 2r at the high edge (a dynamic slice)
        y0 = (cy - r).clamp(0, H - 1)
        x0 = (cx - r).clamp(0, W - 1)
        pad = F.pad(x, (0, 2 * r, 0, 2 * r), value=float("-inf"))
        off = torch.arange(n, device=dev)
        rows = y0[:, None] + off                                 # (N, n)
        cols = x0[:, None] + off
        win = pad[torch.arange(N, device=dev)[:, None, None],
                  rows[:, :, None], cols[:, None, :]]            # (N, n, n)
        ok = ((rows <= (cy + r)[:, None]) & (rows < H))[:, :, None] \
            & ((cols <= (cx + r)[:, None]) & (cols < W))[:, None, :]
        k = torch.where(ok, win, float("-inf")).flatten(1).argmax(dim=1)
        cy = y0 + k // n
        cx = x0 + k % n

    yy = torch.arange(H, device=dev)
    xx = torch.arange(W, device=dev)
    valid = (yy[:, None] == cy[:, None, None]) \
        & (xx[None, :] == cx[:, None, None])
    # may a pixel join from its neighbour above, below, left, right
    pos = x > 0
    from_up = (x[:, 1:] < x[:, :-1] + variance) & pos[:, 1:]
    from_down = (x[:, :-1] < x[:, 1:] + variance) & pos[:, :-1]
    from_left = (x[:, :, 1:] < x[:, :, :-1] + variance) & pos[:, :, 1:]
    from_right = (x[:, :, :-1] < x[:, :, 1:] + variance) & pos[:, :, :-1]
    while True:
        before = valid.clone()
        for _ in range(MASK_PASSES):
            valid[:, 1:] |= valid[:, :-1] & from_up
            valid[:, :-1] |= valid[:, 1:] & from_down
            valid[:, :, 1:] |= valid[:, :, :-1] & from_left
            valid[:, :, :-1] |= valid[:, :, 1:] & from_right
        _mask_counts["passes"] += MASK_PASSES
        _mask_counts["host_syncs"] += 1
        if not bool((valid != before).any()):
            break
    valid = valid.reshape(*lead, H, W)
    return valid, torch.where(valid, X, 0.0)


# ---------------------------------------------------------------------------
# Cone projection (host numpy). Ref: operator.py:183-204, 403-447.
# ---------------------------------------------------------------------------
def _proj(A, B):
    """Projection of A onto the hyperplane defined by B."""
    return A - (A * B).sum() * B / (B ** 2).sum()


def _proj_dist(A, B):
    """Length of the projection of A onto B."""
    return (A * B).sum() / (B ** 2).sum() ** 0.5


def _use_relevant_dim(Y, Q, Vs, index):
    projector = Vs[index]
    del Vs[index]
    Y = _proj(Y, projector)
    Q = _proj(Y, projector)
    for i in range(len(Vs)):
        Vs[i] = _proj(Vs[i], projector)
    return Y, Q, Vs


def _find_relevant_dim(Y, Q, Vs):
    max_t = 0
    index = -1
    for i in range(len(Vs)):
        Y_p = _proj_dist(Y, Vs[i])
        Q_p = _proj_dist(Q, Vs[i])
        if Y_p < 0 and Q_p != Y_p:
            t = -Y_p / (Q_p - Y_p)
        else:
            t = -2
        if t > max_t:
            max_t = t
            index = i
    return index


def _find_Q(Vs, n):
    res = np.zeros(n)
    res[int((n - 1) / 2)] = n
    return res


def prox_cone(X, step=0, G=None):
    """Exact projection of the rows of X onto the cone {x : Gx >= 0}
    (host numpy).  Ref: operator.py:183-204."""
    X = np.array(X, copy=True)
    k, n = X.shape
    for i in range(k):
        Y = X[i]
        Vs = [G[j] for j in range(n)]
        Q = _find_Q(Vs, n)
        for _ in range(n):
            index = _find_relevant_dim(Y, Q, Vs)
            if index != -1:
                Y, Q, Vs = _use_relevant_dim(Y, Q, Vs, index)
            else:
                break
        X[i] = Y
    return X


# ---------------------------------------------------------------------------
# Bulge/disk SED projections (host numpy)
# ---------------------------------------------------------------------------
def project_disk_sed_mean(bulge_sed, disk_sed):
    """Project the disk SED to be bluer than the bulge (mean-slope
    variant).  Ref: operator.py:450-472."""
    bulge_sed = np.asarray(bulge_sed)
    new_sed = np.array(disk_sed, copy=True)
    diff = bulge_sed - new_sed
    slope = (diff[-1] - diff[0]) / (len(bulge_sed) - 1)
    for s in range(1, len(diff) - 1):
        if diff[s] < diff[s - 1]:
            new_sed[s] = bulge_sed[s] - (slope * s + diff[0])
            diff[s] = bulge_sed[s] - new_sed[s]
    return new_sed


def project_disk_sed(bulge_sed, disk_sed):
    """Project the disk SED to be bluer than the bulge (running-difference
    variant).  Ref: operator.py:475-497."""
    bulge_sed = np.asarray(bulge_sed)
    new_sed = np.array(disk_sed, copy=True)
    diff = bulge_sed - new_sed
    for s in range(1, len(diff) - 1):
        if diff[s] < diff[s - 1]:
            new_sed[s] = new_sed[s] + diff[s - 1]
            diff[s] = diff[s - 1]
    return new_sed


def proximal_disk_sed(X, step, peaks, algorithm=project_disk_sed_mean):
    """Make each disk SED bluer than its bulge SED, then project to the
    unit simplex (host numpy).  Ref: operator.py:500-509."""
    X = np.array(X, copy=True)
    for peak in peaks.peaks:
        if "disk" in peak.components and "bulge" in peak.components:
            bulge_k = peak["bulge"].index
            disk_k = peak["disk"].index
            X[:, disk_k] = algorithm(X[:, bulge_k], X[:, disk_k])
    return prox_unity_plus(torch.from_numpy(X), step, axis=0).numpy()


# ---------------------------------------------------------------------------
# Flat-form helpers (the reference's band-diagonal weight construction;
# operator.py:512-667) and the sequential sweep
# ---------------------------------------------------------------------------
def getOffsets(width, coords=None):
    """Flat-index offsets + band slices for the 8-neighbor bands.
    Ref: operator.py:512-527."""
    if coords is None:
        coords = list(NEIGHBOR_OFFSETS)
    offsets = [width * y + x for y, x in coords]
    slices = [slice(None, s) if s < 0 else slice(s, None) for s in offsets]
    slices_inv = [slice(-s, None) if s < 0 else slice(None, -s)
                  for s in offsets]
    return offsets, slices, slices_inv


def diagonalizeArray(arr, shape=None, dtype=np.float64):
    """(8, N) array of each pixel's neighbor values (band-diagonal form)
    and the out-of-bounds mask; every row-wrap neighbor is masked.
    Ref: operator.py:530-572."""
    arr = np.asarray(arr)
    if shape is None:
        height, width = arr.shape
        data = arr
    elif arr.ndim == 1:
        height, width = shape
        data = arr.reshape(height, width)
    else:
        raise ValueError("Expected either a 2D array or a 1D array + shape")

    diagonals = np.zeros((8, height * width), dtype=dtype)
    mask = np.ones((8, height * width), dtype=bool)
    yy, xx = np.mgrid[0:height, 0:width]
    for d, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        ny, nx = yy + dy, xx + dx
        valid = (ny >= 0) & (ny < height) & (nx >= 0) & (nx < width)
        vals = np.zeros((height, width), dtype=dtype)
        vals[valid] = data[ny[valid], nx[valid]]
        diagonals[d] = vals.ravel()
        mask[d] = ~valid.ravel()
    return diagonals, mask


def getRadialMonotonicWeights(shape, neighbor_weight="flat", center=None):
    """(8, N) flat-form radial monotonicity weights (from
    :func:`monotonic_weights`).  Ref: operator.py:591-667."""
    w = monotonic_weights(shape, neighbor_weight=neighbor_weight,
                          center=center)
    return w.reshape(8, -1)


def prox_weighted_monotonic_seq(shape, neighbor_weight="flat",
                                min_gradient=0.1, center=None):
    """The reference's sequential monotonicity sweep as a prox ``f(X,
    step)`` (host numpy, float32): pixels in order of distance from the
    center, each set to ``min(x, (1 - min_gradient) sum_d w_d x_d)`` over
    its positive weights, in the ``d`` order, by the host C library
    (:func:`..native.prox_weighted_monotonic`).  Equal bit for bit to
    :func:`prox_weighted_monotonic` at ``monotonic_depth`` passes in
    float32, in one pass over the pixels.  Ref: operator.py:62-96,
    operators_pybind11.cc:14-36; scarlet_tpu/ops/prox.py:805-826."""
    from .. import native

    height, width = shape
    didx = sort_by_radius(shape, center)[1:]
    offsets = np.array([width * y + x for y, x in NEIGHBOR_OFFSETS],
                       np.int64)
    weights = getRadialMonotonicWeights(
        shape, neighbor_weight=neighbor_weight,
        center=center).astype(np.float32)

    def prox(X, step=0):
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        flat = native.prox_weighted_monotonic(
            np.array(X, dtype=np.float32).reshape(-1), weights, offsets,
            didx, min_gradient)
        return flat.reshape(shape)

    return prox
