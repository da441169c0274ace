"""Operators: FFT convolution, proximal operators and the Hopper kernels
(:mod:`.kernels`, built on first use by :mod:`.build`)."""
