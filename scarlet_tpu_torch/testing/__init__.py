"""Generated test material (no dataset needed) and the regression
harness (scarlet_tpu/testing).

Generated material: single blends and the regression sets 4-8
(:func:`generate_blend_set`), multi-resolution pairs and a large galaxy.
The harness mirrors the reference's scarlet/testing package (api.py,
deblend.py, measure.py, aws.py, settings.py) with local-filesystem
storage instead of AWS DynamoDB/S3: records land as JSON under
``.regression/<branch>/`` and residual images as npz alongside, in the
JAX package's layout.
"""
from . import settings  # noqa: F401
from .blendsets import (  # noqa: F401
    FILTERS,
    default_root,
    generate_blend,
    generate_blend_set,
    generate_real_blend,
    generate_real_blend_set,
)
from .multires import blob_centers, make_pair  # noqa: F401
from .galaxy import (  # noqa: F401
    convolution_probe,
    fit_gaps,
    large_galaxy,
    large_galaxy_engine,
    large_galaxy_fit,
)
from .deblend import deblend  # noqa: F401
from .measure import measurements, mag_diff  # noqa: F401
from .store import save_records, load_records, save_residuals  # noqa: F401
from .api import (  # noqa: F401
    deblend_and_measure,
    deblend_lite_batch,
    bundled_blends,
)
from .plots import metric_distributions, render_dashboard  # noqa: F401
