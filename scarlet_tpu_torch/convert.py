"""Carry a fit's configuration, data and state over from the JAX package.

``from_jax`` takes the JAX package's ``(config, BlendData, BlendState)``
as host values -- the config as a plain dict (``dataclasses.asdict``),
data and state as NamedTuples (or dicts) of numpy arrays (what
``jax.device_get`` returns) -- and gives the port's ``LiteFitConfig``,
``BlendData`` and ``BlendState`` with tensors on ``device``.  Single
blends and batches (leading axis) both convert; the shared monotonicity
tables stay unbatched.

Floating arrays become float32 (the JAX side may run with 64-bit mode
on), integer arrays int32.  Kernel transforms stored as stacked
(re, im) float pairs become complex tensors.

``observations_from_jax`` takes the JAX package's ``Observation`` objects
and gives the port's, with the same data, weights, channels, WCS and PSF
image, so that both packages' multi-resolution fitters can run on the
same observations.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .device import default_device
from .lite import engine
from .optim import AdaproxState, FistaState

__all__ = ["from_jax", "observations_from_jax"]


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(x, device):
    a = np.array(x)   # a writable copy
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int32
    elif np.issubdtype(a.dtype, np.floating):
        dtype = torch.float32
    else:
        raise TypeError(f"cannot convert an array of {a.dtype}")
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def _buckets(x, device):
    return None if x is None else tuple(_tensor(a, device) for a in x)


def _complex(split, device):
    """Stacked (..., 2, C, fh, fw) re/im floats -> complex (..., C, fh, fw)."""
    if split is None:
        return None
    t = _tensor(split, device)
    return torch.complex(t.select(-4, 0), t.select(-4, 1)).contiguous()


def _fields(obj):
    return tuple(obj) if isinstance(obj, Mapping) else obj._fields


def _opt(opts, device):
    """Per bucket, the AdaproxState or FistaState (told apart by its
    fields) of the JAX package as the port's."""
    out = []
    for o in opts:
        kind = FistaState if "z" in _fields(o) else AdaproxState
        out.append(kind(*(_tensor(_get(o, f), device)
                          for f in kind._fields)))
    return tuple(out)


def from_jax(config, data, state, device=None):
    """Convert the JAX package's (config dict, BlendData, BlendState) to
    the port's, on ``device`` (default: the CUDA card)."""
    device = default_device(device)
    engine.pin_float32(device)
    cfg = engine.LiteFitConfig(**dict(config))
    mask = _get(data, "scene_mask")
    out_data = engine.BlendData(
        images=_tensor(_get(data, "images"), device),
        weights=_tensor(_get(data, "weights"), device),
        kernel_rfft=_complex(_get(data, "kernel_rfft"), device),
        grad_kernel_rfft=_complex(_get(data, "grad_kernel_rfft"), device),
        bg_rms=_tensor(_get(data, "bg_rms"), device),
        sed_step_min=_tensor(_get(data, "sed_step_min"), device),
        mono_weights=_buckets(_get(data, "mono_weights"), device),
        mono_keep=_buckets(_get(data, "mono_keep"), device),
        fista_step=_buckets(_get(data, "fista_step"), device),
        box_masks=_buckets(_get(data, "box_masks"), device),
        scene_mask=None if mask is None else _tensor(mask, device),
    )
    out_state = engine.BlendState(
        seds=_buckets(_get(state, "seds"), device),
        morphs=_buckets(_get(state, "morphs"), device),
        origins=_buckets(_get(state, "origins"), device),
        comp_active=_buckets(_get(state, "comp_active"), device),
        sed_opt=_opt(_get(state, "sed_opt"), device),
        morph_opt=_opt(_get(state, "morph_opt"), device),
        active=_tensor(_get(state, "active"), device),
        it=_tensor(_get(state, "it"), device),
        last_loss=_tensor(_get(state, "last_loss"), device),
        box_half=_buckets(_get(state, "box_half"), device),
        step_scale=_buckets(_get(state, "step_scale"), device),
    )
    return cfg, out_data, out_state


def observations_from_jax(observations, device=None):
    """The port's ``models.Observation`` of each of the JAX package's
    observations (read by duck typing from their host fields: ``data``,
    ``weights``, ``channels``, the WCS's crpix/crval/pc/cdelt/ctype and
    ``array_shape``, and the PSF's image), on ``device`` (default: the
    CUDA card).  The port's observations are not matched to a frame yet:
    ``models.Frame.from_observations`` does that."""
    from .models import ImagePSF, Observation
    from .utils import AffineWCS

    device = default_device(device)
    out = []
    for obs in observations:
        wcs = None
        if obs.wcs is not None:
            p = obs.wcs.wcs
            wcs = AffineWCS(crpix=np.array(p.crpix), crval=np.array(p.crval),
                            pc=np.array(p.pc), cdelt=np.array(p.cdelt),
                            ctype=tuple(p.ctype),
                            array_shape=getattr(obs.wcs, "array_shape", None))
        psf = None if obs.psf is None else ImagePSF(
            np.array(obs.psf.get_model()))
        out.append(Observation(np.array(obs.data), list(obs.channels),
                               psf=psf, weights=np.array(obs.weights),
                               wcs=wcs, device=device))
    return out
