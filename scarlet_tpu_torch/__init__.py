"""scarlet_tpu_torch: the lite deblender of ``scarlet_tpu`` in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package ``scarlet_tpu`` is the reference this port is tested
against; this package imports neither it nor JAX.  On CPU tensors every
kernel runs as its plain PyTorch version; on CUDA tensors the kernels of
:mod:`scarlet_tpu_torch.ops.kernels` are compiled with ``nvcc`` on first
use.

Main path::

    obs = lite.LiteObservation(images, variance, weights, psfs, model_psf)
    sources = lite.init_all_sources_main(obs, centers)
    sources = lite.parameterize_sources(sources, obs,
                                        lite.init_adaprox_component)
    lite.LiteBlend(sources, obs).fit(100, device="cuda")
    # or many blends at once:
    config, data, state = parallel.pack_blends(blends, device="cuda")
    state, losses = parallel.fit_batch_device_converged(
        state, data, config, 100, check_every=25)
"""
from . import lite, parallel, testing  # noqa: F401
from .bbox import Box  # noqa: F401

__version__ = "0.1.0"
