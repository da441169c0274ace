"""Parameter helpers of the model tree (only what the lite path uses is
ported so far)."""
from .parameter import relative_step  # noqa: F401
