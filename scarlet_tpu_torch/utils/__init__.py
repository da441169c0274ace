"""Host utilities: a self-contained TAN world coordinate system, and
profiling and synchronized timing (``read_fits`` is not ported yet)."""
from .wcs import AffineWCS, make_tan_wcs  # noqa: F401
from .profiling import trace, annotate, sync, timeit  # noqa: F401
