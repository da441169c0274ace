"""Operators: FFT convolution, interpolation, proximal operators, wavelets
and the Hopper kernels (:mod:`.kernels`, built on first use by
:mod:`.build`; imported where a caller needs it, not here)."""
from . import fft, interpolation, prox, wavelet  # noqa: F401
