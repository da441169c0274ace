"""Generated test material (no dataset needed): single blends and the
regression sets 4-8 (:func:`generate_blend_set`), multi-resolution pairs
and a large galaxy."""
from .blendsets import (  # noqa: F401
    FILTERS,
    default_root,
    generate_blend,
    generate_blend_set,
    generate_real_blend,
    generate_real_blend_set,
)
from .multires import blob_centers, make_pair  # noqa: F401
from .galaxy import large_galaxy, large_galaxy_fit  # noqa: F401
