"""Host utilities: a self-contained TAN world coordinate system, a
minimal FITS reader, and profiling and synchronized timing."""
from .wcs import AffineWCS, make_tan_wcs  # noqa: F401
from .fits import read_fits, read_pickled_wcs  # noqa: F401
from .profiling import trace, annotate, sync, timeit  # noqa: F401
