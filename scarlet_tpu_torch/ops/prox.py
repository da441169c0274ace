"""Proximal operators used by the lite fit and its initialization.

The radial monotonicity projection is computed as an exact Jacobi
fixed-point iteration (:func:`prox_weighted_monotonic`): a pixel's
reference neighbors are strictly closer to the peak, so the dependency
graph is a DAG and ``monotonic_depth`` parallel passes reproduce the
reference's sequential radius-ordered sweep (operators_pybind11.cc:14-36).

The weight tables and the DAG depth are host-side numpy; the projection
itself and the symmetry operators work on torch tensors.  The monotonic
mask (the pixels reachable monotonically from the peak) is a batched
closure on tensors, :func:`monotonic_mask_device`, which
:func:`prox_monotonic_mask` wraps for one host image.

Behavioral references: scarlet/operator.py, scarlet/operators_pybind11.cc.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "NEIGHBOR_OFFSETS",
    "sort_by_radius",
    "monotonic_weights",
    "monotonic_depth",
    "shift_zero",
    "prox_weighted_monotonic",
    "prox_sdss_symmetry",
    "uncentered_operator",
    "prox_uncentered_symmetry",
    "MASK_PASSES",
    "mask_counts",
    "reset_mask_counts",
    "mask_extent",
    "prox_monotonic_mask",
    "monotonic_mask_device",
]

# 8-neighbor offsets in the reference's order (operator.py:84).
NEIGHBOR_OFFSETS = (
    (-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1),
)


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


def prox_sdss_symmetry(X, step=0):
    """min(X, 180deg-rotated X). Ref: operator.py:263-271."""
    return torch.minimum(X, torch.flip(X, (-2, -1)))


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
                             fill=None):
    """Symmetry about an off-center peak. Ref: operator.py:335-400.

    Only the ``"sdss"`` algorithm is ported (the one the lite
    initialization uses)."""
    if algorithm != "sdss":
        raise NotImplementedError(
            f"prox_uncentered_symmetry: algorithm {algorithm!r} is not "
            "ported; only 'sdss' is")
    return uncentered_operator(X, prox_sdss_symmetry, center, step=step,
                               fill=fill)


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
    Ref: scarlet/operator.py:132-180.

    The mask is :func:`monotonic_mask_device`'s closure on the image's
    float32 values, on the CPU; ``bounds`` (min y, max y, min x, max x)
    is its extent, and the model the float32 image times the mask, cast
    back to the image's dtype, as the JAX package's native fill computes
    them.  Only ``max_iter=0`` is ported: the interpolation of orphan
    pixels that ``max_iter > 0`` runs (operators_pybind11.cc:127-232)
    raises ``NotImplementedError``."""
    if max_iter > 0:
        raise NotImplementedError(
            "prox_monotonic_mask: orphan interpolation (max_iter > 0) is not "
            "ported; pass max_iter=0")
    X = np.asarray(X)
    if center is None:
        center = (X.shape[0] // 2, X.shape[1] // 2)
    if center_radius > 0:
        c = (int(center[0]), int(center[1]))
    else:
        c, center_radius = (int(np.round(center[0])),
                            int(np.round(center[1]))), 0
    X32 = np.ascontiguousarray(X, np.float32)
    valid, _ = monotonic_mask_device(torch.from_numpy(X32), torch.tensor(c),
                                     center_radius, variance)
    bounds = np.array([int(b) for b in mask_extent(valid)], dtype=np.int32)
    valid = valid.numpy()
    return valid, (X32 * valid).astype(X.dtype), bounds


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
