"""Frozen copy of the port's monotonicity tables and mask helpers
(``ops/prox.py``), verbatim."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def monotonic_tables(shape, neighbor_weight, centers):
    """The tables ``kernels.monotonic_prox`` reads for one (H, W) box and
    the candidate centers ``centers`` (a list of (y, x)), host numpy:
    weights (ncand, 8, H, W) and keep (ncand, H, W) float64, and the
    number of passes (the largest DAG depth of the candidates: at
    tolerance 0 further passes change nothing).  Memoized."""
    from .cache import Cache

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
