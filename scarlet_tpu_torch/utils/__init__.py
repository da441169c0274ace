"""Host utilities: a self-contained TAN world coordinate system."""
from .wcs import AffineWCS, make_tan_wcs  # noqa: F401
