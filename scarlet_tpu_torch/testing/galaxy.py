"""One large, bright galaxy alone in a frame: the case where the object
tree's boxes go beyond 73 pixels a side, so that its monotonicity
projection takes K1's wide kernel (``ops.kernels.mono_geometry``); the
same galaxy in one lite bucket past 170 pixels, and probes of how that
fit turns on its convolutions' rounding.  Numpy, and torch where a
function says so."""
from __future__ import annotations

import contextlib

import numpy as np

__all__ = ["large_galaxy", "large_galaxy_fit", "large_galaxy_engine",
           "convolution_probe", "fit_gaps"]

# one float32 rounding of a value's scale: the unit roundoff 2^-24
UNIT_ROUNDOFF = 2.0 ** -24


def large_galaxy(seed=3, bands=2, size=120, radius=20.0, amplitude=5.0,
                 noise=0.1, psf_sigma=1.3):
    """An exponential disk of scale ``radius / 1.67835`` px at the center
    of a (bands, size, size) frame, its spectrum falling from 1 to 0.6,
    convolved with a Gaussian PSF of ``psf_sigma`` px, plus Gaussian
    noise of ``noise`` drawn from ``np.random.default_rng(seed)``.
    Returns (images, variance, psfs), float32."""
    from scipy.signal import fftconvolve

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] - size // 2
    prof = np.exp(-np.hypot(yy, xx) / radius * 1.67835)
    psf = np.exp(-(np.mgrid[:21, :21] - 10) ** 2
                 / (2 * psf_sigma ** 2)).prod(0)
    psf = (psf / psf.sum()).astype(np.float32)
    sed = np.linspace(1.0, 0.6, bands)
    img = np.stack([amplitude * s * fftconvolve(prof, psf, mode="same")
                    for s in sed])
    img = (img + noise * rng.normal(size=img.shape)).astype(np.float32)
    return (img, np.full(img.shape, noise ** 2, np.float32),
            np.stack([psf] * bands))


def large_galaxy_fit(device, steps=(10, 20, 30, 40), boxsize=71, **kw):
    """The galaxy of :func:`large_galaxy` (``kw``) seeded as a
    ``SingleExtendedSource`` in a ``boxsize`` box and fitted on
    ``device`` to each iteration count of ``steps`` in turn (``e_rel``
    0): its edge pull grows the box to 81 at iteration 10 (at the
    defaults; on the CPU a change of the images by 1e-7 of their values
    moves the losses by ~3e-7, where a galaxy 4 times as bright parts
    them by ~2e-2).  Returns (blend, the source's box shape after each
    step)."""
    from .. import models

    img, var, psfs = large_galaxy(**kw)
    ch = [f"b{i}" for i in range(img.shape[0])]
    frame = models.Frame(img.shape, channels=ch,
                         psf=models.GaussianPSF(sigma=0.8, boxsize=15))
    obs = models.Observation(img, ch, psf=models.ImagePSF(psfs),
                             weights=1 / var, device=device).match(frame)
    c = img.shape[-1] // 2
    src = models.SingleExtendedSource(frame, (float(c), float(c)), obs,
                                      boxsize=boxsize)
    blend = models.Blend([src], obs)
    boxes = []
    for n in steps:
        blend.fit(n, e_rel=0)
        boxes.append(tuple(src.bbox.shape[-2:]))
    return blend, boxes


def large_galaxy_engine(device, size=180, box=181,
                        centers=((90, 90), (40, 130)), platform=None):
    """The lite engine's (config, data, state) on ``device`` for
    :func:`large_galaxy` (3 bands, ``size`` x ``size``, radius 30) with a
    second source on ``centers[1]``: the port's own init on the host, one
    bucket forced to ``box`` (capped at ``size + 1``), the config of
    ``platform`` (``LiteBlend.engine_setup``).  Torch."""
    from .. import lite

    img, var, psfs = large_galaxy(seed=3, bands=3, size=size, radius=30.0)
    mpsf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = lite.LiteObservation(img, var, (1.0 / var).astype(np.float32),
                               psfs, model_psf=mpsf, device="cpu")
    src = lite.parameterize_sources(
        lite.init_all_sources_main(obs, list(centers)), obs,
        lite.init_adaprox_component)
    return lite.LiteBlend(src, obs).engine_setup(box_size=box,
                                                 device=device,
                                                 platform=platform)


@contextlib.contextmanager
def convolution_probe(scale=0.0, exact=False, device=None):
    """Within the block, every convolution of the lite engine
    (``engine._convolve``) runs on ``device`` (None: its input's), in
    float64 with ``exact``, and returns its result times ``1 + scale``,
    rounded to the input's type on the input's device.  Torch."""
    import torch

    from ..lite import engine

    conv = engine._convolve

    def probe(x, kernel_rfft, config):
        if kernel_rfft is None:
            return x
        y, k = x, kernel_rfft
        if device is not None:
            y, k = y.to(device), k.to(device)
        if exact:
            y, k = y.double(), k.to(torch.complex128)
        out = conv(y, k, config)
        return (out.double() * (1.0 + scale)).to(x.dtype).to(x.device)

    engine._convolve = probe
    try:
        yield
    finally:
        engine._convolve = conv


def fit_gaps(device, losses, n_iter=10, size=180, box=181):
    """How the ``n_iter`` losses ``losses`` of the :func:`large_galaxy_engine`
    fit on ``device`` stand to the CPU's, each the largest gap relative to
    the CPU's largest loss, every fit with ``device``'s config: ``cpu``,
    to the CPU's fit; ``rounding``, the least of the gaps to the CPU's
    fits with every convolution's result times 1 - u, 1 and 1 + u (u =
    2^-24, one float32 rounding of its scale); ``host_convolutions``,
    the fit on ``device`` with its convolutions run on the CPU, to the
    CPU's fit; ``exact``, between the two devices' fits with every
    convolution in float64.  Torch."""
    import torch

    from ..lite import engine

    platform = torch.device(device).type

    def fit(where, **probe):
        config, data, state = large_galaxy_engine(where, size, box,
                                                  platform=platform)
        with convolution_probe(**probe):
            return engine.fit_scan(state, data, config, n_iter)[1].cpu() \
                .double().numpy()

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    losses = np.asarray(losses, np.float64)
    near = {s: fit("cpu", scale=s * UNIT_ROUNDOFF) for s in (-1, 0, 1)}
    return dict(cpu=gap(losses, near[0]),
                rounding=min(gap(losses, v) for v in near.values()),
                rounding_each={s: gap(losses, v) for s, v in near.items()},
                host_convolutions=gap(fit(device, device="cpu"), near[0]),
                exact=gap(fit(device, exact=True), fit("cpu", exact=True)))
