"""Constraints: proximal operators attached to parameters.  Port of
``scarlet_tpu/models/constraint.py``.

Every constraint is a function ``f(X, step) -> X'`` on a tensor, on the
tensor's device.  :class:`MonotonicityConstraint` is the Hopper kernel K1
(``kernels.monotonic_prox`` at tolerance 0) on a CUDA tensor and its
plain version on the CPU; with ``fit_center_radius > 0`` the kernel picks
the candidate center's table by an index computed on the device.
Behavioral reference: scarlet/constraint.py (file:line cited per class).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import kernels
from ..ops import prox as prox_ops

__all__ = [
    "Constraint",
    "ConstraintChain",
    "PositivityConstraint",
    "NormalizationConstraint",
    "L0Constraint",
    "L1Constraint",
    "ThresholdConstraint",
    "MonotonicityConstraint",
    "MonotonicMaskConstraint",
    "SymmetryConstraint",
    "CenterOnConstraint",
    "LeakyConstraint",
    "mask_constraint_counts",
    "reset_mask_constraint_counts",
]


class Constraint:
    """Prox wrapper with signature ``f(X, step) -> X'``.
    Ref: scarlet/constraint.py:10-55."""

    def __init__(self, f=None):
        self.f = f

    def __call__(self, X, step):
        if self.f is not None:
            return self.f(X, step)
        return X


class ConstraintChain:
    """Alternating projections over a list of constraints, in order.
    Ref: scarlet/constraint.py:58-80."""

    def __init__(self, *constraints, repeat=1):
        assert isinstance(repeat, int) and repeat >= 1
        self.constraints = constraints
        self.repeat = repeat

    def __call__(self, X, step):
        for _ in range(self.repeat):
            for c in self.constraints:
                X = c(X, step)
        return X


class PositivityConstraint(Constraint):
    """X >= zero. Ref: constraint.py:83-92."""

    def __init__(self, zero=0):
        self.zero = zero

    def __call__(self, X, step):
        return torch.clamp_min(X, self.zero)


class NormalizationConstraint(Constraint):
    """Normalize sum or max to unity. Ref: constraint.py:95-114."""

    def __init__(self, type="sum"):
        type = type.lower()
        assert type in ("sum", "max")
        self.type = type

    def __call__(self, X, step):
        if self.type == "sum":
            return X / X.sum()
        return X / X.max()


class L0Constraint(Constraint):
    """Hard thresholding. Ref: constraint.py:117-131.

    An array ``thresh`` (broadcast against X) is held as a tensor on each
    device and dtype it is called with, made on the first call there, so
    that a prox sub-iteration copies nothing to the device; it compares
    in X's dtype."""

    def __init__(self, thresh, type="absolute"):
        self.thresh = thresh
        self.type = type
        self._on = {}

    def __call__(self, X, step):
        return prox_ops.prox_hard(X, step, thresh=self._thresh_on(X),
                                  type=self.type)

    def _thresh_on(self, X):
        if np.ndim(self.thresh) == 0:
            return self.thresh
        key = (X.device, X.dtype)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = torch.as_tensor(
                np.asarray(self.thresh)).to(X.device, X.dtype)
        return t

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_on"] = {}
        return state


class L1Constraint(Constraint):
    """Soft thresholding. Ref: constraint.py:134-145."""

    def __init__(self, thresh, type="absolute"):
        self.thresh = thresh
        self.type = type

    def __call__(self, X, step):
        return prox_ops.prox_soft(X, step, thresh=self.thresh, type=self.type)


class ThresholdConstraint(Constraint):
    """Cut pixels below a log-histogram noise threshold, on the device.
    Ref: constraint.py:148-180."""

    def __call__(self, X, step):
        return prox_ops.prox_threshold(X, step)

    def threshold(self, morph):
        """Host-side exact threshold, mirroring constraint.py:165-180."""
        return prox_ops.threshold(morph)


class MonotonicityConstraint(Constraint):
    """Radially monotonic morphology. Ref: constraint.py:183-234.

    ``fit_center_radius > 0`` searches the window around the box center
    for the peak and projects about it: the candidate tables are built in
    the JAX package's order (both the window and the candidates clipped at
    the box edge, scarlet_tpu/models/constraint.py:176-205) and the
    kernel reads the candidate's index from the device, so nothing waits
    on the host.  ``use_mask`` overwrites the pixels the host flood fill
    reaches with the mask model (host-side, for initialization: the C
    library's fill through :func:`prox_ops.prox_monotonic_mask`).
    """

    def __init__(self, neighbor_weight="flat", min_gradient=0.1,
                 use_mask=False, fit_center_radius=0):
        self.neighbor_weight = neighbor_weight
        self.min_gradient = min_gradient
        self.use_mask = use_mask
        self.fit_center = fit_center_radius > 0
        self.fit_center_radius = int(fit_center_radius)

    def __call__(self, morph, step):
        H, W = morph.shape
        center = (H // 2, W // 2)

        if self.fit_center:
            result = self._call_fit_center(morph, center)
        else:
            result = prox_ops.build_prox_monotonic(
                (H, W), neighbor_weight=self.neighbor_weight,
                min_gradient=self.min_gradient, center=center)(morph, step)

        if self.use_mask:
            valid, _morph, _bounds = prox_ops.prox_monotonic_mask(
                morph.detach().cpu().numpy(), step, center=center,
                center_radius=0, variance=0, max_iter=0)
            result = torch.where(
                torch.from_numpy(valid).to(morph.device),
                torch.from_numpy(_morph).to(morph.device, morph.dtype),
                result)
        return result

    def candidates(self, shape):
        """The candidate centers of a box, in table order (row-major over
        the window offsets, each clipped into the box)."""
        r = self.fit_center_radius
        H, W = shape
        cy, cx = H // 2, W // 2
        return [(min(max(cy + dy, 0), H - 1), min(max(cx + dx, 0), W - 1))
                for dy in range(-r, r + 1) for dx in range(-r, r + 1)]

    def candidate_index(self, morph):
        """The (1, 1) table index of the window's first maximum, on the
        morphology's device: the window starts at the center minus r,
        clipped at the low edge, and keeps its (2r+1) size unless the box
        ends first; the peak's offset from the center is clipped to the
        window (scarlet_tpu/models/constraint.py:188-203)."""
        r = self.fit_center_radius
        H, W = morph.shape
        cy, cx = H // 2, W // 2
        y0, x0 = max(cy - r, 0), max(cx - r, 0)
        wy, wx = min(2 * r + 1, H - y0), min(2 * r + 1, W - x0)
        k = morph[y0:y0 + wy, x0:x0 + wx].reshape(-1).argmax()
        py, px = k // wx + y0, k % wx + x0
        idx = (torch.clamp(py - cy + r, 0, 2 * r) * (2 * r + 1)
               + torch.clamp(px - cx + r, 0, 2 * r))
        return idx.reshape(1, 1)

    def _call_fit_center(self, morph, center):
        wt, kt, n_iter, _ = prox_ops.device_tables(
            morph.shape, self.neighbor_weight, self.candidates(morph.shape),
            morph.device, morph.dtype)
        return kernels.monotonic_prox(
            morph[None, None], self.candidate_index(morph), wt, kt, n_iter,
            self.min_gradient, tol=0.0)[0, 0]


# host round trips of MonotonicMaskConstraint since the last
# reset_mask_constraint_counts(): calls (one read of the planes to the
# host and one copy back each, whatever their number), planes projected
# and the seconds of the host projection (host clock, from the end of the
# read to the end of the projection)
_mask_constraint_counts = {"calls": 0, "planes": 0, "seconds": 0.0}


def mask_constraint_counts():
    """The host round trips of :class:`MonotonicMaskConstraint` (a copy)."""
    return dict(_mask_constraint_counts)


def reset_mask_constraint_counts():
    _mask_constraint_counts.update(calls=0, planes=0, seconds=0.0)


class MonotonicMaskConstraint(Constraint):
    """Flood-fill monotonicity from the center (host-side): each call
    reads the planes to the host, projects them one by one with
    :func:`prox_ops.prox_monotonic_mask` (the host C library's flood fill
    and orphan fill) and copies the result back (counted by
    :func:`mask_constraint_counts`).  Ref: constraint.py:237-259."""

    def __init__(self, center, center_radius=1, variance=0.0, max_iter=3):
        self.center = center
        self.center_radius = center_radius
        self.variance = variance
        self.max_iter = max_iter

    def _prox(self, morph, step):
        return prox_ops.prox_monotonic_mask(
            morph, step, center=self.center,
            center_radius=self.center_radius, variance=self.variance,
            max_iter=self.max_iter)

    def __call__(self, morph, step):
        host = morph.detach().cpu().numpy()
        t0 = time.perf_counter()
        _mask_constraint_counts["calls"] += 1
        _mask_constraint_counts["planes"] += 1 if morph.ndim == 2 \
            else len(host)
        if morph.ndim == 2:
            out = self._prox(host, step)[1]
        else:
            out = np.array([self._prox(m, step)[1] for m in host])
        _mask_constraint_counts["seconds"] += time.perf_counter() - t0
        return torch.from_numpy(out).to(morph.device)


class SymmetryConstraint(Constraint):
    """Soft symmetry about the box center. Ref: constraint.py:262-273."""

    def __init__(self, strength=1):
        self.strength = strength

    def __call__(self, morph, step):
        return prox_ops.prox_soft_symmetry(morph, step,
                                           strength=self.strength)


# per (shape, tiny, dtype, device): tiny at the center pixel, -inf
# elsewhere, so that one maximum applies the floor
_CENTER_FLOORS = {}


class CenterOnConstraint(Constraint):
    """Keep the center pixel above ``tiny``. Ref: constraint.py:276-287.

    One elementwise maximum against a cached floor (``tiny`` at the
    center, -inf elsewhere): the same values as raising the center pixel
    alone."""

    def __init__(self, tiny=1e-6):
        self.tiny = tiny

    def __call__(self, morph, step):
        key = (tuple(morph.shape), float(self.tiny), morph.dtype,
               morph.device)
        floor = _CENTER_FLOORS.get(key)
        if floor is None:
            H, W = morph.shape
            floor = torch.full((H, W), float("-inf"), dtype=morph.dtype)
            floor[H // 2, W // 2] = self.tiny
            floor = _CENTER_FLOORS[key] = floor.to(morph.device)
        return torch.maximum(morph, floor)


class LeakyConstraint(Constraint):
    """Blend prox output with the input. Ref: constraint.py:290-301."""

    def __init__(self, constraint, leak=0.05):
        self.constraint = constraint
        self.leak = leak

    def __call__(self, x, step):
        return (1 - self.leak) * self.constraint(x, step) + self.leak * x
