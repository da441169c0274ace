"""Generated test material (no dataset needed)."""
from .blendsets import FILTERS, generate_blend  # noqa: F401
from .multires import blob_centers, make_pair  # noqa: F401
from .galaxy import large_galaxy, large_galaxy_fit  # noqa: F401
