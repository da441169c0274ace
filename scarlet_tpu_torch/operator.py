"""Proximal-operator namespace mirroring the reference's
``scarlet.operator`` module (reference: scarlet/operator.py:1-667); the
port of ``scarlet_tpu/operator.py``.

The implementations live in :mod:`scarlet_tpu_torch.ops.prox`; this
module keeps the reference's import surface
(``scarlet.operator.prox_weighted_monotonic`` etc.).
"""
from .ops.prox import (  # noqa: F401
    sort_by_radius,
    prox_weighted_monotonic,
    prox_weighted_monotonic_seq,
    build_prox_monotonic,
    prox_monotonic_mask,
    prox_cone,
    uncentered_operator,
    prox_sdss_symmetry,
    prox_soft_symmetry,
    prox_kspace_symmetry,
    prox_uncentered_symmetry,
    project_disk_sed,
    project_disk_sed_mean,
    proximal_disk_sed,
    getOffsets,
    diagonalizeArray,
    getRadialMonotonicWeights,
    prox_plus,
    prox_hard,
    prox_hard_plus,
    prox_soft,
    prox_soft_plus,
    prox_unity,
    prox_unity_plus,
    threshold,
    prox_threshold,
    monotonic_weights,
    monotonic_depth,
    NEIGHBOR_OFFSETS,
)
