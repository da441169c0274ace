"""Batched fitting of many blends on one device, the device stream
(init, fit and records of raw pixel stacks) and device peak detection."""
from .batch import (  # noqa: F401
    BatchConfig,
    pack_batch,
    pack_blends,
    unpack_blends,
    replicate_blend,
    select_blends,
    fit_batch,
    fit_batch_converged,
    fit_batch_device_converged,
    fit_batch_device_dispatch,
    fit_batch_device_collect,
)
from .detection import (  # noqa: F401
    detect_peaks_device,
    label_components_device,
    peak_mask_from_plane,
)
from .stream import (  # noqa: F401
    stream_setup,
    stream_records,
    deblend_device_stream,
)
