"""Batched deblending: many blends fitted at once on one device.

``engine.fit_step`` takes a leading batch axis, and each blend stops
updating on its own through the ``active`` mask while the batch runs on.
Distinct blends batch through a shared layout (:func:`pack_blends`):
scenes zero-pad to the largest (weight-0 padding never enters the
likelihood), component slots pad with ``comp_active=False``, and every
blend uses the common box and FFT shape.

The monotonicity tables depend only on the config, so they are shared
and unbatched: one copy on the device whatever the batch size.
"""
from __future__ import annotations

import dataclasses

import torch

from ..lite import engine
from ..lite.utils import to_numpy
from ..ops import fft as fft_ops

__all__ = [
    "BatchConfig",
    "pack_batch",
    "pack_blends",
    "unpack_blends",
    "replicate_blend",
    "select_blends",
    "fit_batch",
    "fit_batch_converged",
    "fit_batch_device_converged",
    "fit_batch_device_dispatch",
    "fit_batch_device_collect",
]

BatchConfig = engine.LiteFitConfig

# BlendData fields shared (unbatched) across a batch
_SHARED_FIELDS = ("mono_weights", "mono_keep")


def _unshared(data):
    return data._replace(**{name: None for name in _SHARED_FIELDS})


def _with_shared(batched, data):
    return batched._replace(**{name: getattr(data, name)
                               for name in _SHARED_FIELDS})


def pack_batch(blend_setups):
    """Stack per-blend (data, state) pairs along a new leading axis.

    All blends must share one config; :func:`pack_blends` builds distinct
    blends to a common layout first.  The shared tables come from the first
    blend.
    """
    datas, states = zip(*blend_setups)
    data = engine.map_tree(lambda *xs: torch.stack(xs),
                           *[_unshared(d) for d in datas])
    state = engine.map_tree(lambda *xs: torch.stack(xs), *states)
    return _with_shared(data, datas[0]), state


def pack_blends(blends, e_rel=1e-4, min_iter=1, device=None):
    """Build distinct ``LiteBlend``s to one shared layout on ``device``
    and stack them.

    The common layout is the elementwise maximum over the batch: scene
    shape, single-bucket box size, component-slot count and FFT shape.
    Returns ``(config, data, state)`` for :func:`fit_batch`; write results
    back with :func:`unpack_blends`.
    """
    if not blends:
        raise ValueError("pack_blends needs at least one blend")
    shapes = [b.observation.shape for b in blends]
    C = shapes[0][0]
    if any(s[0] != C for s in shapes):
        raise ValueError(f"channel counts differ: {[s[0] for s in shapes]}")
    H = max(s[1] for s in shapes)
    W = max(s[2] for s in shapes)
    cap = max(H, W) + 1

    box = 1
    n_slots = 1
    for bl in blends:
        n_slots = max(n_slots, len(bl.components))
        for c in bl.components:
            s = min(max(c.bbox.shape[-2], c.bbox.shape[-1]), cap)
            box = max(box, s + (s % 2 == 0))

    fft_shape = None
    for bl in blends:
        dk = bl.observation.diff_kernel
        if dk is not None:
            fs = fft_ops.minimal_same_fft_shape(
                (C, H, W), tuple(dk.image.shape), axes=(1, 2))
            fft_shape = fs if fft_shape is None else tuple(
                max(a, b) for a, b in zip(fft_shape, fs))

    configs, setups = [], []
    for bl in blends:
        cfg, d, s = bl.engine_setup(
            e_rel, min_iter, scene_shape=(C, H, W), box_size=box,
            n_slots=n_slots, fft_shape=fft_shape, device=device)
        configs.append(cfg)
        setups.append((d, s))

    # scene_pad is overhang-derived per blend; the batch takes the maximum
    pad = max(c.scene_pad for c in configs)
    config = dataclasses.replace(configs[0], scene_pad=pad)
    for c in configs[1:]:
        if dataclasses.replace(c, scene_pad=pad) != config:
            raise ValueError(
                f"blends produced incompatible engine configs: {c} vs "
                f"{config}")

    data, state = pack_batch(setups)
    return config, data, state


def unpack_blends(blends, state, losses=None, reweight=True):
    """Write a batched fit back onto its ``LiteBlend`` objects: SEDs,
    morphologies, optimizer moments, iteration counts and, from
    ``losses`` (n_iter, B), each blend's loss history.  ``reweight``
    applies the post-fit flux redistribution (lite/measure.py:39-91)."""
    from ..lite.measure import weight_sources

    if losses is not None:
        losses = to_numpy(losses)
    # one bulk device-to-host copy; per-blend slicing stays on the host
    host = engine.map_tree(to_numpy, state)
    for i, bl in enumerate(blends):
        sub = engine.map_tree(lambda x: x[i], host)
        ran = int(sub.it) - bl.it
        if losses is not None and ran > 0:
            bl.loss.extend(losses[:ran, i].tolist())
        bl.it = int(sub.it)
        bl._write_back(sub)
        if reweight:
            weight_sources(bl)
    return blends


def replicate_blend(data, state, batch):
    """Tile one blend's (data, state) ``batch`` times; the shared tables
    stay unbatched."""
    def rep(x):
        return x[None].repeat((batch,) + (1,) * x.ndim)

    return (_with_shared(engine.map_tree(rep, _unshared(data)), data),
            engine.map_tree(rep, state))


def select_blends(data, state, index, device=None):
    """The blends ``index`` (a list of batch positions) of a batch, on
    ``device`` (default: where they are)."""
    index = torch.as_tensor(index, dtype=torch.long)

    def pick(x):
        x = x[index.to(x.device)]
        return x if device is None else x.to(device)

    def move(x):
        return x if device is None else x.to(device)

    shared = data._replace(**{name: engine.map_tree(move, getattr(data, name))
                              for name in _SHARED_FIELDS})
    return (_with_shared(engine.map_tree(pick, _unshared(data)), shared),
            engine.map_tree(pick, state))


def fit_batch(state, data, config, n_iter):
    """``n_iter`` iterations of every blend of the batch.  Returns
    (final_state, losses (n_iter, B))."""
    return engine.fit_scan(state, data, config, n_iter)


def fit_batch_converged(state, data, config, max_iter, segment=10):
    """Fit until every blend of the batch has converged, or ``max_iter``
    iterations, reading ``state.active.any()`` on the host after each
    segment of ``segment`` iterations (scarlet_tpu/parallel/batch.py:
    323-346).  Works on a copy of ``state``.  Returns (final_state,
    losses (n_run, B))."""
    state = engine.map_tree(lambda x: x.clone(), state)
    losses = []
    done = 0
    while done < max_iter:
        n = min(segment, max_iter - done)
        state, seg = engine.fit_scan(state, data, config, n)
        losses.append(seg)
        done += n
        if not bool(state.active.any()):
            break
    if not losses:
        return state, state.last_loss.new_zeros((0,) + state.active.shape)
    return state, torch.cat(losses)


def fit_batch_device_converged(state, data, config, max_iter,
                               check_every=10):
    """Fit until every blend has converged, or ``max_iter`` iterations.

    Runs segments of ``check_every`` iterations and reads
    ``state.active.any()`` on the host once per segment; the last
    ``max_iter % check_every`` iterations run as a tail, so the count stops
    exactly at the cap.  Returns (final_state, losses (n_run, B)) for the
    ``n_run`` iterations executed; converged blends repeat their logL.
    """
    check_every = min(check_every, max_iter)
    n_full = max_iter // check_every
    rem = max_iter - n_full * check_every
    losses = []
    done = 0
    while done < n_full and bool(state.active.any()):
        state, seg = engine.fit_scan(state, data, config, check_every)
        losses.append(seg)
        done += 1
    if rem and bool(state.active.any()):
        state, seg = engine.fit_scan(state, data, config, rem)
        losses.append(seg)
    if not losses:
        return state, state.last_loss.new_zeros((0,) + state.active.shape)
    return state, torch.cat(losses)


def fit_batch_device_dispatch(state, data, config, max_iter,
                              check_every=10):
    """Start :func:`fit_batch_device_converged` on a copy of ``state`` and
    return a handle for :func:`fit_batch_device_collect`.

    The JAX package dispatches its whole fit as one asynchronous device
    program.  Here the fit reads ``state.active.any()`` on the host once
    per segment, so this call returns once the last segment has been
    enqueued: the caller's next work overlaps at most the kernels still in
    flight (the last segment when the cap ends the fit).
    """
    state = engine.map_tree(lambda x: x.clone(), state)
    return fit_batch_device_converged(state, data, config, max_iter,
                                      check_every)


def fit_batch_device_collect(handle, max_iter):
    """The (final_state, losses (n_run, B)) of a
    :func:`fit_batch_device_dispatch` handle, ``n_run <= max_iter``."""
    out, losses = handle
    return out, losses[:max_iter]
