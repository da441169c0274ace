"""One large, bright galaxy alone in a frame: the case where the object
tree's boxes go beyond 73 pixels a side, so that its monotonicity
projection takes K1's wide kernel (``ops.kernels.mono_geometry``).
Numpy only."""
from __future__ import annotations

import numpy as np

__all__ = ["large_galaxy", "large_galaxy_fit"]


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
