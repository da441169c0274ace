"""Batched fitting of many blends on one device or split over the ranks
of a ``torch.distributed`` group, the device stream (init, fit and
records of raw pixel stacks), device peak detection and the batched
multi-resolution fitter; the multiprocess host pipeline
(:class:`BlendPipeline`)."""
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
    LocalMesh,
    make_mesh,
    shard_batch,
    fit_batch_sharded,
)
from .pipeline import (  # noqa: F401
    BlendPipeline,
    deblend_stream,
    build_lite_blend,
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
from .multires import (  # noqa: F401
    MultiResFitter,
    multires_init,
    multires_records,
    deblend_multires,
)
