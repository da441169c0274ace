"""The plain reference of the lite device stream: a frozen copy of the
port's plain code (its init, fit iteration and records, with the plain
versions of its kernels), run on inputs that the benchmark generated.

It imports nothing of the port, takes nothing that the port made, and
works everything out again from the raw stacks: the PSF kernels, the
detected catalogs, the seeds, the slot layout and the fit.  The port's
``deblend_device_stream`` fits a call's blends in one chunk, compacts the
unconverged ones into residual batches and refits the blends whose init
overflowed the slots at a larger slot count where ``retry_overflow`` is
on (without it such a blend keeps the components that its slots hold);
each blend's fit is independent of the others in the batch, so here the
sampled blends are initialized, fitted and measured as one batch, at the
slot count that holds every one of their components with the retry, at
the configured one without it.
"""
from __future__ import annotations

import torch

from . import stream

__all__ = ["deblend_reference"]


def _grown_slots(n_slots, need):
    """The port's overflow retry's slot count: ``n_slots`` grown in steps
    of 4 until it holds ``need`` components."""
    return n_slots + -(-(need - n_slots) // 4) * 4


@torch.no_grad()
def deblend_reference(images, variance, psfs, centers, center_active,
                      model_psf, *, box_size, n_slots, max_iter,
                      check_every, min_snr, e_rel, device, max_peaks=None,
                      detect_scales=3, retry_overflow=True):
    """Records (the port's ``stream_records`` dicts) of the blends
    (numpy stacks; ``centers=None`` detects the catalogs)."""
    kw = dict(box_size=box_size, min_snr=min_snr, e_rel=e_rel, device=device,
              max_peaks=max_peaks, detect_scales=detect_scales)
    config, data, state, aux = stream.stream_setup(
        images, variance, psfs, centers, model_psf, center_active,
        n_slots=n_slots, **kw)
    need = int(aux["n_active"].max())
    if retry_overflow and need > n_slots:
        config, data, state, aux = stream.stream_setup(
            images, variance, psfs, centers, model_psf, center_active,
            n_slots=_grown_slots(n_slots, need), **kw)
    state = stream.engine.map_tree(lambda x: x.clone(), state)
    out, losses = stream.fit_batch_device_converged(
        state, data, config, max_iter, check_every)
    return stream.stream_records(out, losses, aux)
