"""Batched deblending: many blends fitted at once on one device.

``engine.fit_step`` takes a leading batch axis, and each blend stops
updating on its own through the ``active`` mask while the batch runs on.
Distinct blends batch through a shared layout (:func:`pack_blends`):
scenes zero-pad to the largest (weight-0 padding never enters the
likelihood), component slots pad with ``comp_active=False``, and every
blend uses the common box and FFT shape.

The monotonicity tables depend only on the config, so they are shared
and unbatched: one copy on the device whatever the batch size.

A batch also splits over the ranks of a ``torch.distributed`` process
group laid out as a ("blends", "bands") grid (:func:`make_mesh`): each
rank fits its share of the blends (:func:`shard_batch`) and, with
:func:`fit_batch_sharded`'s ``shard_bands``, its share of the channels,
summing the cross-band reductions over its band group.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

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
    "LocalMesh",
    "make_mesh",
    "shard_batch",
    "fit_batch_sharded",
]

BatchConfig = engine.LiteFitConfig

# BlendData fields shared (unbatched) across a batch
_SHARED_FIELDS = ("mono_weights", "mono_keep")
# BlendData fields that hold the channels on axis 1 (after the batch
# axis): split over the band ranks of a sharded fit, as the JAX package's
# specs do (scarlet_tpu/parallel/batch.py:380-390)
_CHANNEL_FIELDS = ("images", "weights", "kernel_rfft", "grad_kernel_rfft",
                   "bg_rms", "sed_step_min")


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


# ---------------------------------------------------------------------------
# Across ranks: a ("blends", "bands") grid of torch.distributed ranks
# ---------------------------------------------------------------------------
class LocalMesh:
    """The ("blends", "bands") mesh of one device without a process group,
    as :func:`make_mesh` returns it when no group is initialized: its
    groups are None, so :func:`shard_batch` puts the whole batch on its
    device and :func:`fit_batch_sharded` fits it there, as on a group of
    world size 1, without starting one."""

    mesh_dim_names = ("blends", "bands")
    shape = (1, 1)

    def __init__(self, device_type="cuda"):
        self.device_type = device_type

    def get_group(self, mesh_dim=None):
        return None

    def size(self):
        return 1


def make_mesh(n_devices=None, bands=1, device_type="cuda"):
    """A ``DeviceMesh`` with dims ("blends", "bands") over the first
    ``n_devices`` ranks (default: all) of the already initialized default
    process group: rank ``r`` sits at (r // bands, r % bands).  Each rank
    works on ``cuda:<LOCAL_RANK or rank> % device_count`` (several ranks
    may share a card), or on the CPU with ``device_type="cpu"``.  Starts
    no process group of its own: without one it returns the one-device
    :class:`LocalMesh` (the current card, or the CPU), and raises
    ``RuntimeError`` when asked for more than one device."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices in (None, 1) and bands == 1:
            return LocalMesh(device_type)
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process group "
            "(call torch.distributed.init_process_group first)")
    from torch.distributed.device_mesh import DeviceMesh

    if n_devices is None:
        n_devices = dist.get_world_size()
    if bands < 1 or n_devices % bands:
        raise ValueError(f"{n_devices} ranks do not split into bands={bands}")
    if device_type == "cuda":
        torch.cuda.set_device(_cuda_index())
    return DeviceMesh(device_type,
                      torch.arange(n_devices).reshape(n_devices // bands,
                                                      bands),
                      mesh_dim_names=("blends", "bands"))


def _cuda_index():
    rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return rank % torch.cuda.device_count()


def _rank_device(mesh):
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    if isinstance(mesh, LocalMesh):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", _cuda_index())


def _mesh_size(mesh, name):
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _part(x, dim, index, parts):
    """Part ``index`` of ``parts`` equal parts of ``x`` along ``dim``."""
    if x is None:
        return None
    n = x.shape[dim] // parts
    return x.narrow(dim, index * n, n).contiguous()


def shard_batch(data, state, mesh):
    """This rank's share of a batch's blends, on this rank's device (see
    :func:`make_mesh`): part ``i`` of the blends axis for the rank at
    index ``i`` of the "blends" dim, every channel; the shared
    monotonicity tables whole.  What the JAX package's GSPMD layout puts
    on each device (scarlet_tpu/parallel/batch.py:439-464).  Raises
    ``ValueError`` when the blends do not split evenly."""
    group = mesh.get_group("blends")
    parts, index = (1, 0) if group is None else (
        dist.get_world_size(group), dist.get_rank(group))
    B = state.active.shape[0]
    if B % parts:
        raise ValueError(f"{B} blends do not split over blends={parts}")
    device = _rank_device(mesh)

    def put(x):
        return _part(x, 0, index, parts).to(device)

    shared = {name: engine.map_tree(lambda x: x.to(device),
                                    getattr(data, name))
              for name in _SHARED_FIELDS}
    data = engine.map_tree(put, _unshared(data))._replace(**shared)
    return data, engine.map_tree(put, state)


def _channel_shard(data, state, index, parts):
    """Part ``index`` of the channels of a batch's channel fields, SEDs
    and SED optimizer states (leaves of the SEDs' rank)."""
    data = data._replace(**{name: _part(getattr(data, name), 1, index,
                                        parts)
                            for name in _CHANNEL_FIELDS})
    nd = state.seds[0].ndim
    state = state._replace(
        seds=tuple(_part(x, -1, index, parts) for x in state.seds),
        sed_opt=engine.map_tree(
            lambda x: _part(x, -1, index, parts) if x.ndim == nd else x,
            state.sed_opt))
    return data, state


def _all_gather(x, group, dim):
    """``x`` of every rank of ``group``, joined along ``dim`` in rank
    order.  Gloo carries a CUDA tensor through a host copy."""
    staged = x.cpu() if x.is_cuda and dist.get_backend(group) == "gloo" \
        else x
    staged = staged.to(torch.uint8) if x.dtype == torch.bool \
        else staged.contiguous()
    parts = [torch.empty_like(staged)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts, dim).to(device=x.device, dtype=x.dtype)


def fit_batch_sharded(state, data, config, n_iter, mesh, shard_bands=False):
    """``n_iter`` iterations of a batch split over the ranks of ``mesh``
    (:func:`make_mesh`); every rank calls it with the whole batch.
    Mirrors scarlet_tpu/parallel/batch.py:349-425.

    The blends axis is pure data parallelism (:func:`shard_batch`).  With
    ``shard_bands`` and more than one band rank, each rank also holds C /
    bands channels of the images, weights, kernel transforms, noise
    levels, SED step floors, SEDs and SED optimizer states, and fits with
    ``scene_shape=(C // bands, H, W)``, ``band_axis="bands"`` and
    ``n_bands_total=C``: the engine sums its cross-band reductions over
    the band group, and the FFT convolution stays local to the shard
    (channels are batch dims of the 2D transform).  Without
    ``shard_bands`` the band ranks repeat the same fit, as in JAX.  The
    fields the JAX package's specs do not list are handled as there: the
    DFT operators of ``conv_mode="dft"`` are built on each rank from the
    local shapes, FISTA's base steps, the box masks and the scene mask
    follow the blends, and the shared tables go whole to every rank.

    Returns (final_state, losses (n_iter, B)) of the whole batch on every
    rank, on this rank's device.  Raises ``ValueError`` when the channels
    do not split over the band ranks, or the blends over the blend ranks.
    """
    bands = _mesh_size(mesh, "bands")
    use_bands = bool(shard_bands) and bands > 1
    local_cfg = config
    if use_bands:
        C, H, W = config.scene_shape
        if C % bands != 0:
            raise ValueError(
                f"channel count {C} not divisible by bands={bands}")
        local_cfg = dataclasses.replace(
            config, scene_shape=(C // bands, H, W), band_axis="bands",
            n_bands_total=C)
    data, state = shard_batch(data, state, mesh)
    if use_bands:
        group = mesh.get_group("bands")
        data, state = _channel_shard(data, state, dist.get_rank(group),
                                     bands)
        with engine.band_group("bands", group):
            state, losses = fit_batch(state, data, local_cfg, n_iter)
        nd = state.seds[0].ndim
        state = state._replace(
            seds=tuple(_all_gather(x, group, -1) for x in state.seds),
            sed_opt=engine.map_tree(
                lambda x: _all_gather(x, group, -1) if x.ndim == nd else x,
                state.sed_opt))
    else:
        state, losses = fit_batch(state, data, local_cfg, n_iter)
    group = mesh.get_group("blends")
    if group is None:
        return state, losses
    return (engine.map_tree(lambda x: _all_gather(x, group, 0), state),
            _all_gather(losses, group, 1))
