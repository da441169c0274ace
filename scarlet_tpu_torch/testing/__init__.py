"""Generated test material (no dataset needed)."""
from .blendsets import FILTERS, generate_blend  # noqa: F401
