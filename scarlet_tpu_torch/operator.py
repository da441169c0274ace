"""Proximal-operator namespace mirroring the reference's
``scarlet.operator`` module (reference: scarlet/operator.py:1-667); the
port of ``scarlet_tpu/operator.py``.

The implementations live in :mod:`scarlet_tpu_torch.ops.prox`; this
module keeps the reference's import surface
(``scarlet.operator.prox_weighted_monotonic`` etc.).  As in the
reference, its proxes take numpy arrays too: a numpy argument becomes a
CPU tensor of the same dtype at this boundary, and the result is a
tensor, which ``np.asarray`` reads.  ``ops.prox`` itself stays
tensor-only (the fit's hot paths call it).
"""
import functools

import numpy as np
import torch

from .ops import prox as _prox
from .ops.prox import (  # noqa: F401
    sort_by_radius,
    prox_monotonic_mask,
    prox_cone,
    project_disk_sed,
    project_disk_sed_mean,
    proximal_disk_sed,
    getOffsets,
    diagonalizeArray,
    getRadialMonotonicWeights,
    prox_weighted_monotonic_seq,
    threshold,
    monotonic_weights,
    monotonic_depth,
    NEIGHBOR_OFFSETS,
)


def _as_tensor(X):
    """A numpy array as a CPU tensor of its dtype (a copy); anything else
    as it is."""
    if isinstance(X, np.ndarray):
        return torch.from_numpy(np.array(X))
    return X


def _numpy_in(fn):
    """``fn`` taking its first argument as numpy too."""
    @functools.wraps(fn)
    def call(X, *args, **kwargs):
        return fn(_as_tensor(X), *args, **kwargs)
    return call


prox_plus = _numpy_in(_prox.prox_plus)
prox_hard = _numpy_in(_prox.prox_hard)
prox_hard_plus = _numpy_in(_prox.prox_hard_plus)
prox_soft = _numpy_in(_prox.prox_soft)
prox_soft_plus = _numpy_in(_prox.prox_soft_plus)
prox_unity = _numpy_in(_prox.prox_unity)
prox_unity_plus = _numpy_in(_prox.prox_unity_plus)
prox_threshold = _numpy_in(_prox.prox_threshold)
prox_sdss_symmetry = _numpy_in(_prox.prox_sdss_symmetry)
prox_soft_symmetry = _numpy_in(_prox.prox_soft_symmetry)
prox_kspace_symmetry = _numpy_in(_prox.prox_kspace_symmetry)
prox_weighted_monotonic = _numpy_in(_prox.prox_weighted_monotonic)


@functools.wraps(_prox.build_prox_monotonic)
def build_prox_monotonic(*args, **kwargs):
    return _numpy_in(_prox.build_prox_monotonic(*args, **kwargs))


def _write_back_check(X, center, fill):
    """The JAX package writes an off-centre window back with ``X.at``,
    which a numpy ``X`` lacks unless a ``fill`` makes a fresh array
    (scarlet_tpu/ops/prox.py:604-609): raise where it does."""
    if not isinstance(X, np.ndarray) or fill is not None:
        return
    if center is None:
        center = np.unravel_index(np.argmax(X), X.shape)
    if tuple(int(c) for c in center) != (X.shape[0] // 2, X.shape[1] // 2):
        raise TypeError("an off-centre window is written back into X, "
                        "which must then be a tensor (or give a fill); "
                        "the JAX package raises here too")


@functools.wraps(_prox.uncentered_operator)
def uncentered_operator(X, func, center=None, fill=None, **kwargs):
    _write_back_check(X, center, fill)
    return _prox.uncentered_operator(_as_tensor(X), func, center, fill,
                                     **kwargs)


@functools.wraps(_prox.prox_uncentered_symmetry)
def prox_uncentered_symmetry(X, step=0, center=None, algorithm="kspace",
                             fill=None, shift=None, strength=0.5):
    _write_back_check(X, center, fill)
    return _prox.prox_uncentered_symmetry(_as_tensor(X), step, center,
                                          algorithm, fill, shift, strength)
