"""ctypes bindings of the host C library (``kernels.cc``) and their numpy
twins.

The library holds the C++ equivalents of the reference's pybind11
extensions (operators_pybind11.cc, detect_pybind11.cc) through a plain C
ABI, with the names and arguments of the JAX package's
``scarlet_tpu.native``: host numpy in, host numpy out.  It is built on
first use by :mod:`.build` (``g++ -O3 -ffp-contract=off``, no
``-march=native``) and serves the port's host paths: the sequential
monotonicity sweep of the lite seeds (``prox_weighted_monotonic``) and
the monotonic mask's flood fill and orphan fill
(``get_valid_monotonic_pixels``, ``linear_interpolate_invalid_pixels``).
A missing compiler or a failed build raises; no path falls back to the
twins.

Beside each C function stands its plain numpy twin (``plain_*``, the
same arguments, the same in-place updates), which the tests and the chip
smoke test hold it to bit for bit; nothing on the port's paths calls
them.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import build as _build

__all__ = [
    "available",
    "prox_weighted_monotonic",
    "apply_filter",
    "get_valid_monotonic_pixels",
    "linear_interpolate_invalid_pixels",
    "label_components",
    "plain_prox_weighted_monotonic",
    "plain_apply_filter",
    "plain_get_valid_monotonic_pixels",
    "plain_linear_interpolate_invalid_pixels",
    "plain_label_components",
]

_lib = None


def _load():
    """Build the library if needed, load it and declare its entry points;
    raises when it does not build or load."""
    global _lib
    if _lib is not None:
        return _lib
    path, _, _, _ = _build.build()
    lib = ctypes.CDLL(str(path))

    # the array arguments are passed as addresses (:func:`_ptr` checks
    # their dtype and layout): numpy's ``ndpointer`` converts each through
    # ``ctypes.cast``, ~30 us an argument, which outweighed the fills on
    # 21 x 21 planes
    i64 = ctypes.c_int64
    f32p = i64p = u8p = i32p = ctypes.c_void_p

    lib.prox_weighted_monotonic.argtypes = [
        f32p, f32p, i64p, i64p, i64, i64, ctypes.c_float]
    lib.prox_weighted_monotonic.restype = None
    lib.apply_filter.argtypes = [
        f32p, f32p, i64, i64p, i64p, i64p, i64p, i64, i64, f32p]
    lib.apply_filter.restype = None
    lib.get_valid_monotonic_pixels.argtypes = [
        f32p, i64, i64, i64, i64, u8p, u8p, ctypes.c_double, i32p,
        ctypes.c_double]
    lib.get_valid_monotonic_pixels.restype = None
    lib.linear_interpolate_invalid_pixels.argtypes = [
        i64p, i64p, i64, u8p, f32p, u8p, i64, i64, ctypes.c_double,
        ctypes.c_int, i32p]
    lib.linear_interpolate_invalid_pixels.restype = None
    lib.label_components.argtypes = [f32p, i64, i64, ctypes.c_double, i32p]
    lib.label_components.restype = i64

    _lib = lib
    return lib


def available():
    """Whether the library builds and loads here.  The port's paths do
    not ask: they call the library and raise where it does not load."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# The C functions
# ---------------------------------------------------------------------------
def _ptr(a, dtype):
    """The address of ``a``'s data; a C-contiguous ndarray of ``dtype``."""
    if type(a) is not np.ndarray or a.dtype != dtype or \
            not a.flags.c_contiguous:
        raise TypeError(f"expected a C-contiguous {np.dtype(dtype).name} "
                        f"array, got {type(a).__name__} "
                        f"{getattr(a, 'dtype', '')}")
    return a.ctypes.data


def _check_masks(shape, unchecked, orphans, bounds):
    """The in-place arguments of the fills: (H, W) masks and 4 bounds (the
    C code indexes them without checks)."""
    if unchecked.shape != shape or orphans.shape != shape or \
            bounds.shape != (4,):
        raise ValueError(f"masks {unchecked.shape} and {orphans.shape}, "
                         f"bounds {bounds.shape} for an image {shape}")


def prox_weighted_monotonic(flat_img, weights, offsets, didx, min_gradient):
    """In-place sequential monotonicity sweep (reference semantics): each
    pixel of ``didx`` in turn set to ``min(x, (1 - min_gradient) sum_e
    w_e x_e)`` over its positive weights, in the ``e`` order.

    flat_img: (N,) float32 (modified in place when it is float32 and
    contiguous; returned); weights: (8, N) float32; offsets: (8,) int64
    flat offsets of the neighbours; didx: (M,) int64 indices sorted by
    distance from the center (which is left out)."""
    lib = _load()
    flat_img = np.ascontiguousarray(flat_img, np.float32)
    weights = np.ascontiguousarray(weights, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    didx = np.ascontiguousarray(didx, np.int64)
    if weights.size != 8 * flat_img.size or offsets.size != 8:
        raise ValueError(f"weights {weights.shape} and offsets "
                         f"{offsets.shape} for {flat_img.size} pixels")
    if didx.size and (didx.min() < 0 or didx.max() >= flat_img.size):
        raise IndexError(f"a pixel index outside the {flat_img.size} "
                         "pixels")
    lib.prox_weighted_monotonic(
        _ptr(flat_img, np.float32), _ptr(weights, np.float32),
        _ptr(offsets, np.int64), _ptr(didx, np.int64), len(didx),
        flat_img.size, np.float32(min_gradient))
    return flat_img


def apply_filter(image, values, y_start, y_end, x_start, x_end):
    """Real-space sparse convolution of the (H, W) image by shifted block
    adds in float32: for each non-zero value ``v``, ``result[y_start:H -
    y_end, x_start:W - x_end] += v * image[y_end:H - y_start, x_end:W -
    x_start]``, in the order of ``values``."""
    lib = _load()
    image = np.ascontiguousarray(image, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    H, W = image.shape
    result = np.zeros_like(image)
    ys, ye, xs, xe = (np.ascontiguousarray(b, np.int64)
                      for b in (y_start, y_end, x_start, x_end))
    if not all(b.size == values.size for b in (ys, ye, xs, xe)):
        raise ValueError("one bound of each side per filter value")
    if values.size and min(b.min() for b in (ys, ye, xs, xe)) < 0:
        raise IndexError("a negative filter bound")
    lib.apply_filter(
        _ptr(image, np.float32), _ptr(values, np.float32), len(values),
        _ptr(ys, np.int64), _ptr(ye, np.int64), _ptr(xs, np.int64),
        _ptr(xe, np.int64), H, W, _ptr(result, np.float32))
    return result


def get_valid_monotonic_pixels(image, i, j, unchecked, orphans, variance,
                               bounds, thresh=0.0):
    """Flood fill from (i, j) through 4-neighbours that are below their
    predecessor plus ``variance`` and above ``thresh`` (compared in
    double): each joins (``unchecked`` and ``orphans`` cleared, ``bounds``
    (min y, max y, min x, max x) grown); a neighbour that fails becomes an
    orphan.  Iterative, with an explicit stack.  In place on the (H, W)
    uint8 ``unchecked`` and ``orphans`` and the (4,) int32 ``bounds``."""
    lib = _load()
    image = np.ascontiguousarray(image, np.float32)
    H, W = image.shape
    _check_masks(image.shape, unchecked, orphans, bounds)
    if not (0 <= i < H and 0 <= j < W):
        raise IndexError(f"start ({i}, {j}) outside the image {(H, W)}")
    lib.get_valid_monotonic_pixels(
        _ptr(image, np.float32), H, W, int(i), int(j),
        _ptr(unchecked, np.uint8), _ptr(orphans, np.uint8),
        float(variance), _ptr(bounds, np.int32), float(thresh))


def linear_interpolate_invalid_pixels(rows, cols, unchecked, model, orphans,
                                      variance, recursive, bounds):
    """Fill the unchecked pixels among (rows, cols) of the float32
    ``model`` from their neighbours' gradients (float32 differences summed
    in double) and continue the fill from each filled pixel
    (``recursive``) or mark its unchecked neighbours as orphans; a pixel
    with no usable gradient and no unchecked neighbour becomes a zero
    orphan.  In place on ``unchecked``, ``model``, ``orphans`` and
    ``bounds``."""
    lib = _load()
    H, W = model.shape
    _check_masks(model.shape, unchecked, orphans, bounds)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    if rows.size != cols.size:
        raise ValueError(f"{rows.size} rows and {cols.size} columns")
    if rows.size and (rows.min() < 0 or rows.max() >= H or cols.min() < 0
                      or cols.max() >= W):
        raise IndexError(f"a pixel outside the model {(H, W)}")
    lib.linear_interpolate_invalid_pixels(
        _ptr(rows, np.int64), _ptr(cols, np.int64), len(rows),
        _ptr(unchecked, np.uint8), _ptr(model, np.float32),
        _ptr(orphans, np.uint8), H, W, float(variance),
        int(bool(recursive)), _ptr(bounds, np.int32))


def label_components(image, thresh=0.0):
    """4-connected component labels of ``image > thresh`` in raster order
    of each component's first pixel; returns ``(labels, n)``, labels
    (H, W) int32 (0 outside every component)."""
    lib = _load()
    image = np.ascontiguousarray(image, np.float32)
    H, W = image.shape
    labels = np.zeros((H, W), np.int32)
    n = lib.label_components(_ptr(image, np.float32), H, W, float(thresh),
                             _ptr(labels, np.int32))
    return labels, int(n)


# ---------------------------------------------------------------------------
# The numpy twins: the same arguments and updates, in plain Python loops
# ---------------------------------------------------------------------------
_STEPS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def plain_prox_weighted_monotonic(flat_img, weights, offsets, didx,
                                  min_gradient):
    """:func:`prox_weighted_monotonic` in numpy float32 scalars."""
    flat_img = np.ascontiguousarray(flat_img, np.float32)
    weights = np.ascontiguousarray(weights, np.float32)
    offsets = [int(o) for o in offsets]
    scale = np.float32(1.0) - np.float32(min_gradient)
    for i in np.asarray(didx, np.int64).tolist():
        ref = np.float32(0.0)
        for e in range(8):
            w = weights[e, i]
            if w > 0:
                ref = ref + flat_img[offsets[e] + i] * w
        flat_img[i] = min(flat_img[i], ref * scale)
    return flat_img


def plain_apply_filter(image, values, y_start, y_end, x_start, x_end):
    """:func:`apply_filter` as numpy float32 block adds in the same
    order."""
    image = np.ascontiguousarray(image, np.float32)
    H, W = image.shape
    result = np.zeros_like(image)
    for n, v in enumerate(np.asarray(values, np.float32)):
        if v == 0:
            continue
        ys, ye = int(y_start[n]), int(y_end[n])
        xs, xe = int(x_start[n]), int(x_end[n])
        rows, cols = H - ys - ye, W - xs - xe
        if rows <= 0 or cols <= 0:
            continue
        result[ys:ys + rows, xs:xs + cols] += \
            v * image[ye:ye + rows, xe:xe + cols]
    return result


def _plain_flood(image, i0, j0, unchecked, orphans, variance, bounds,
                 thresh):
    H, W = image.shape
    stack = [(i0, j0)]
    while stack:
        ci, cj = stack.pop()
        limit = float(image[ci, cj]) + variance
        for di, dj in _STEPS:
            ni, nj = ci + di, cj + dj
            if not (0 <= ni < H and 0 <= nj < W) or not unchecked[ni, nj]:
                continue
            value = float(image[ni, nj])
            if value < limit and value > thresh:
                unchecked[ni, nj] = 0
                orphans[ni, nj] = 0
                bounds[0] = min(bounds[0], ni)
                bounds[1] = max(bounds[1], ni)
                bounds[2] = min(bounds[2], nj)
                bounds[3] = max(bounds[3], nj)
                stack.append((ni, nj))
            else:
                orphans[ni, nj] = 1


def plain_get_valid_monotonic_pixels(image, i, j, unchecked, orphans,
                                     variance, bounds, thresh=0.0):
    """:func:`get_valid_monotonic_pixels` in Python (the same stack
    order)."""
    _plain_flood(np.ascontiguousarray(image, np.float32), int(i), int(j),
                 unchecked, orphans, float(variance), bounds, float(thresh))


def plain_linear_interpolate_invalid_pixels(rows, cols, unchecked, model,
                                            orphans, variance, recursive,
                                            bounds):
    """:func:`linear_interpolate_invalid_pixels` in Python: the gradients
    in numpy float32, their sum in double."""
    H, W = model.shape
    variance = float(variance)
    for i, j in zip(np.asarray(rows).tolist(), np.asarray(cols).tolist()):
        if not unchecked[i, j]:
            continue
        unchecked[i, j] = 0
        total = 0.0
        valid = 0
        had_unchecked = False
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            i2, j2 = i + 2 * di, j + 2 * dj
            i1, j1 = i + di, j + dj
            if not (0 <= i2 < H and 0 <= j2 < W):
                continue
            m2, m1 = model[i2, j2], model[i1, j1]
            if m2 > m1:
                if unchecked[i2, j2] or unchecked[i1, j1]:
                    had_unchecked = True
                else:
                    total += float(m1 - (m2 - m1))
                    valid += 1
        if total > 0.0:
            model[i, j] = total / valid
            orphans[i, j] = 0
            bounds[0] = min(bounds[0], i)
            bounds[1] = max(bounds[1], i)
            bounds[2] = min(bounds[2], j)
            bounds[3] = max(bounds[3], j)
            if recursive:
                _plain_flood(model, i, j, unchecked, orphans, variance,
                             bounds, 0.0)
            else:
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    ni, nj = i + di, j + dj
                    if 0 <= ni < H and 0 <= nj < W and unchecked[ni, nj]:
                        orphans[ni, nj] = 1
        elif not had_unchecked:
            orphans[i, j] = 1
            model[i, j] = 0


def plain_label_components(image, thresh=0.0):
    """:func:`label_components` in Python (the same raster scan and stack
    order)."""
    image = np.ascontiguousarray(image, np.float32)
    H, W = image.shape
    thresh = float(thresh)
    flat = image.reshape(-1)
    labels = np.zeros(H * W, np.int32)
    current = 0
    for p in range(H * W):
        if labels[p] != 0 or not (float(flat[p]) > thresh):
            continue
        current += 1
        labels[p] = current
        stack = [p]
        while stack:
            q = stack.pop()
            ci, cj = divmod(q, W)
            for di, dj in _STEPS:
                ni, nj = ci + di, cj + dj
                if not (0 <= ni < H and 0 <= nj < W):
                    continue
                r = ni * W + nj
                if labels[r] == 0 and float(flat[r]) > thresh:
                    labels[r] = current
                    stack.append(r)
    return labels.reshape(H, W), current
