"""scarlet_tpu_torch.lite: single-instrument, same-grid deblending with
analytic gradients and a batched fit engine on torch tensors.

Port of ``scarlet_tpu.lite`` (reference: scarlet/lite/).
"""
from .utils import (  # noqa: F401
    to_numpy,
    insert_image,
    project_morph_to_center,
    integrated_gaussian,
    integrated_circular_gaussian,
    get_circle_mask,
)
from .parameters import (  # noqa: F401
    LiteParameter,
    FistaParameter,
    AdaproxParameter,
)
from .models import (  # noqa: F401
    LiteComponent,
    LiteFactorizedComponent,
    LiteSource,
    LiteObservation,
    LiteBlend,
)
from .measure import calculate_snr, weight_sources  # noqa: F401
from .initialization import (  # noqa: F401
    get_min_psf,
    init_monotonic_morph,
    multifit_seds,
    init_main_parameters,
    init_adaprox_component,
    init_fista_component,
    init_all_sources_main,
    WaveletInitParameters,
    init_wavelet_source,
    init_all_sources_wavelets,
    parameterize_sources,
)
