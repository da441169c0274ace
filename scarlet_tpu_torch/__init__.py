"""scarlet_tpu_torch: the lite deblender and the batched multi-resolution
fitter of ``scarlet_tpu`` in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (H100).

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
    # or raw (B, C, H, W) stacks and catalogs, initialized on the device:
    records, state, losses, aux = parallel.deblend_device_stream(
        images, variance, psfs, centers, model_psf, box_size=59,
        n_slots=16, chunk=128, compact=50, device="cuda")
    # several instruments at different resolutions (models.Observation
    # with a WCS each, models.Frame.from_observations):
    fitter = parallel.MultiResFitter(observations, box_size=31)

The object tree (scarlet's quickstart)::

    frame = models.Frame(images.shape, channels, psf=models.GaussianPSF(0.8))
    obs = models.Observation(images, channels, psf=models.ImagePSF(psfs),
                             weights=weights).match(frame)
    sources, skipped = initialization.init_all_sources(
        frame, centers, obs, max_components=2, min_snr=30, silent=True)
    models.Blend(sources, obs).fit(100, e_rel=1e-4)
    fluxes = [measure.flux(s) for s in sources]
"""
from . import (  # noqa: F401
    detect, initialization, lite, measure, models, operator, parallel,
    testing, utils)
from .bbox import Box  # noqa: F401
from .ops.wavelet import Starlet  # noqa: F401

__version__ = "0.1.0"
