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

__all__ = ["from_jax", "observations_from_jax", "sources_from_jax"]


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


def _step(step):
    """The port's step rule of a JAX package step: a number, the JAX
    ``relative_step`` or a ``partial`` of it (its arrays as numpy)."""
    from functools import partial

    from .models.parameter import relative_step

    if not callable(step):
        return step if step is None else float(step)
    if isinstance(step, partial):
        assert step.func.__name__ == "relative_step", step
        return partial(relative_step, *step.args, **{
            k: np.array(v) if np.ndim(v) else v
            for k, v in step.keywords.items()})
    assert step.__name__ == "relative_step", step
    return relative_step


def _box(b):
    from .bbox import Box

    return Box(tuple(b.shape), origin=tuple(b.origin))


def _copy_param(dst, src, device):
    """Carry the JAX Parameter ``src``'s value, moments, fixed flag and
    step onto the port's ``dst``."""
    from .models.parameter import place

    for key in ("value", "m", "v", "vhat"):
        x = getattr(src, key)
        setattr(dst, key, None if x is None else place(np.array(x), device))
    dst.fixed = bool(src.fixed)
    dst.step = _step(src.step)
    return dst


def _morphology(m, frame):
    """The port's morphology of the JAX package's ``m`` (by class name)."""
    from . import models

    kind = type(m).__name__
    p = {q.name: np.array(q.value) for q in m.parameters}
    if kind == "ExtendedSourceMorphology":
        chain = m.parameters[0].constraint.constraints
        mono = next((c for c in chain
                     if type(c).__name__ == "MonotonicityConstraint"), None)
        symmetric = any(type(c).__name__ == "SymmetryConstraint"
                        for c in chain)
        center = np.asarray(m.pixel_center, float)
        if m.shift is not None:
            center = center + np.array(m.shift.value)
        out = models.ExtendedSourceMorphology(
            frame, center, p["image"], bbox=_box(m.bbox),
            monotonic=None if mono is None else mono.neighbor_weight,
            symmetric=symmetric,
            min_grad=0 if mono is None else mono.min_gradient,
            shifting=m.shifting, resizing=m.resizing)
        if mono is not None:
            port_mono = out.parameters[0].constraint.constraints[0]
            port_mono.use_mask = mono.use_mask
            port_mono.fit_center = mono.fit_center
            port_mono.fit_center_radius = mono.fit_center_radius
        return out
    if kind == "ImageMorphology":
        return models.ImageMorphology(
            frame, p["image"], bbox=_box(m.bbox), shifting=m.shifting,
            shift=p["shift"] if m.shifting else None, resizing=m.resizing)
    if kind == "GaussianMorphology":
        return models.GaussianMorphology(frame, p["center"], p["radius"],
                                         ellipticity=p["ellipticity"],
                                         boxsize=m.bbox.shape[-1])
    if kind == "SpergelMorphology":
        return models.SpergelMorphology(frame, p["center"], p["nu"],
                                        p["radius"],
                                        ellipticity=p["ellipticity"],
                                        boxsize=m.bbox.shape[-1])
    if kind == "PointSourceMorphology":
        return models.PointSourceMorphology(frame, p["center"])
    if kind == "StarletMorphology":
        return _starlet_morphology(m, p["coeffs"], frame)
    raise TypeError(f"sources_from_jax: no port of morphology {kind}")


def _starlet_morphology(m, coeffs, frame):
    """The port's StarletMorphology of the JAX package's ``m``: its box,
    ``monotonic`` flag and coefficient planes (their number may be that
    of an earlier, larger box), and its constraint's settings: the
    thresholds per scale (uniform over each plane of the JAX array) or
    the mask's centre."""
    from . import models
    from .ops.wavelet import starlet_reconstruction

    image = starlet_reconstruction(torch.from_numpy(coeffs)).numpy()
    out = models.StarletMorphology(frame, image, bbox=_box(m.bbox),
                                   monotonic=bool(m.monotonic))
    jc = m.parameters[0].constraint
    if m.monotonic:
        constraint = models.MonotonicMaskConstraint(
            tuple(int(c) for c in jc.center),
            center_radius=jc.center_radius, variance=jc.variance,
            max_iter=jc.max_iter)
    else:
        constraint = out.parameters[0].constraint
        l0 = constraint.constraints[1]
        l0.thresh = np.array(jc.constraints[1].thresh)[:, :1, :1]
    q = out.parameters[0]
    out._parameters = (models.Parameter(
        coeffs, name=q.name, constraint=constraint, step=q.step),)
    return out


def _component(c, frame, device):
    """The port's component of the JAX package's ``c``: a factorized
    component (any source class of that kind) or a combined one."""
    from .models import component, source, spectrum

    kind = type(c).__name__
    cls = getattr(source, kind, None) or getattr(component, kind)
    obj = cls.__new__(cls)
    if hasattr(c, "children") and type(c.children[0]).__name__ not in (
            "TabulatedSpectrum",):
        component.CombinedComponent.__init__(
            obj, [_component(k, frame, device) for k in c.children],
            operation=getattr(c, "operation", "add"))
    else:
        spec, morph = c.children
        port_spec = spectrum.TabulatedSpectrum(
            frame, np.array(spec.parameters[0].value))
        port_morph = _morphology(morph, frame)
        component.FactorizedComponent.__init__(obj, frame, port_spec,
                                               port_morph)
    for dst, src in zip(obj.parameters, c.parameters):
        assert dst.name == src.name and dst.shape == tuple(
            np.shape(src.value)), (dst, src)
        _copy_param(dst, src, device)
    if hasattr(c, "center"):
        obj.center = np.array(c.center)
    return obj


def sources_from_jax(sources, frame, device=None):
    """The port's sources of the JAX package's ``sources`` (read by duck
    typing from host fields: class names, boxes, each Parameter's value,
    float step, fixed flag and moments, each morphology's center, shift
    and constraint settings), in the port's model ``frame``, with their
    parameters on ``device`` (default: the CUDA card).  The port's
    constructors supply the constraints and step rules, so both packages
    fit from the same start."""
    device = default_device(device)
    return [_component(s, frame, device) for s in sources]
