"""Batched fitting of many blends on one device."""
from .batch import (  # noqa: F401
    pack_batch,
    pack_blends,
    unpack_blends,
    replicate_blend,
    select_blends,
    fit_batch,
    fit_batch_device_converged,
)
