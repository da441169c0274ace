"""Whether a blend's fit depends on the batch it is fitted in: the first
``n`` of the het cell's blends fitted alone and inside a batch of ``2 n``
on one device, and the first operation whose output for those blends
differs.

Three steps, each on the same device:

1. ``stream_setup`` of the first ``n`` blends and of all ``2 n``: the
   largest difference of every state and data leaf over the first ``n``
   rows (the init's own dependence on the batch);
2. one ``engine.fit_step`` of the ``2 n`` state and of its first ``n``
   rows, with every PyTorch operation's output and every kernel
   wrapper's output recorded in order (``TorchDispatchMode``): of the
   outputs with a row per blend, the first whose rows of the first ``n``
   blends differ, the records before it, and each operation that differs
   in that step;
3. ``fit_batch`` over ``--iters`` iterations of both: the largest
   difference of the seds, morphologies and losses, relative to each
   field's largest value.

The het cell is bench.py's ``make_heterogeneous``: generated (5, 58, 48)
blends, ``default_rng(42)``, box 59, 16 slots.  Run from the
repository's root, on the card by default::

    python -m scarlet_tpu_torch.tools.batch_invariance --n 64 --iters 20

It prints one JSON object.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..lite import engine, integrated_circular_gaussian
from ..ops import kernels
from ..parallel import batch, stream
from ..testing import generate_blend

# the kernel wrappers the fit step calls through ``engine.kernels``
WRAPPERS = ("scene_assembly", "grad_gather", "monotonic_prox",
            "prox_chain", "fused_morph_update")
# operations whose output is uninitialized memory (a kernel fills it)
_UNSET = ("empty", "new_empty", "empty_like", "empty_strided")


def het_blends(n, seed=42):
    """``n`` generated het blends as stacked numpy arrays (images,
    variance, psfs, centers, active)."""
    rng = np.random.default_rng(seed)
    blends = [generate_blend(rng) for _ in range(n)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((n, K, 2), np.int32)
    active = np.zeros((n, K), bool)
    for i, b in enumerate(blends):
        k = len(b["catalog"])
        centers[i, :k, 0] = np.round(b["catalog"]["y"])
        centers[i, :k, 1] = np.round(b["catalog"]["x"])
        active[i, :k] = True
    return ([np.stack([b[k] for b in blends])
             for k in ("images", "variance", "psfs")], centers, active)


def _leaves(tree, prefix=""):
    """(name, tensor) of every tensor leaf of a NamedTuple tree."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        out = []
        for name, x in zip(names, tree):
            out += _leaves(x, f"{prefix}.{name}" if prefix else str(name))
        return out
    return []


def _rows(x, big, n):
    """x's first ``n`` rows where its leading axis is the batch of
    ``big`` blends; else x."""
    return x[:n] if x.dim() and x.shape[0] == big else x


def _diff(a, b):
    """(bitwise equal, largest absolute difference) of two tensors of one
    shape (NaN equal to NaN)."""
    if a.dtype == torch.bool or not a.is_floating_point() \
            and not a.is_complex():
        return bool(torch.equal(a, b)), float((a != b).sum())
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    same = bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    d = (a.double() - b.double()).abs().nan_to_num(0.0)
    return same, float(d.max()) if d.numel() else 0.0


class _Recorder(TorchDispatchMode):
    """Every operation's tensor outputs, in order, cloned."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__ if hasattr(func, "__name__") else str(func)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor):
                self.log.append((str(func), name.split(".")[0] in _UNSET,
                                 t.detach().clone()))
        return out


def _recorded_step(state, data, config):
    """One fit step with every operation's and kernel wrapper's outputs
    recorded: the log [(name, uninitialized, tensor)]."""
    rec = _Recorder()
    saved = {w: getattr(kernels, w) for w in WRAPPERS}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            for x in _leaves(out):
                rec.log.append((f"kernel {name}", False,
                                x[1].detach().clone()))
            return out
        # the wrapper counts its launches on the name it is called by
        call.__dict__.update(fn.__dict__)
        return call

    try:
        for w, fn in saved.items():
            setattr(kernels, w, wrap(w, fn))
        with rec:
            engine.fit_step(state, data, config)
    finally:
        for w, fn in saved.items():
            setattr(kernels, w, fn)
    return rec.log


def first_difference(state, data, config, n):
    """Step 2: the records of one step of the whole batch and of its
    first ``n`` blends, compared in order."""
    big = state.active.shape[0]
    small = (engine.map_tree(lambda x: _rows(x, big, n), state),
             engine.map_tree(lambda x: _rows(x, big, n), data))
    # a warm-up step each: first calls fill caches (the projection's tap
    # tables), whose operations the recorded steps must not hold
    engine.fit_step(state, data, config)
    engine.fit_step(*small, config)
    log_big = _recorded_step(state, data, config)
    log_small = _recorded_step(*small, config)
    first, differing, compared = None, {}, 0
    for i, ((name, unset, a), (name_b, _, b)) in enumerate(
            zip(log_small, log_big)):
        if name != name_b:
            raise AssertionError(f"the two steps part at record {i}: "
                                 f"{name} against {name_b}")
        # per-blend outputs only: a reduction over the batch (a scalar,
        # a maximum over all blends) differs with the batch by design
        if unset or not (b.dim() and a.dim() and b.shape[0] == big
                         and a.shape[0] == n and a.shape[1:] == b.shape[1:]):
            continue
        b = b[:n]
        compared += 1
        same, d = _diff(a, b)
        if not same:
            scale = float(b.abs().max()) if b.is_floating_point() else 1.0
            differing.setdefault(name, dict(records=0, max_abs=0.0,
                                            max_rel=0.0, shape=list(a.shape)))
            r = differing[name]
            r["records"] += 1
            r["max_abs"] = max(r["max_abs"], d)
            r["max_rel"] = max(r["max_rel"], d / scale if scale else d)
            if first is None:
                first = dict(record=i, op=name, shape=list(a.shape),
                             max_abs=d, max_rel=d / scale if scale else d)
    return dict(records=len(log_small), compared=compared,
                equal_before=None if first is None else first["record"],
                first=first, differing=differing)


def init_difference(stacks, centers, active, n, device):
    """Step 1: ``stream_setup`` of the first ``n`` blends against the
    first ``n`` rows of the whole batch's."""
    mp = integrated_circular_gaussian(sigma=0.8)[None].astype(np.float32)
    kw = dict(box_size=59, n_slots=16, device=device)
    big = stream.stream_setup(*stacks, centers, mp, center_active=active,
                              **kw)
    small = stream.stream_setup(*(s[:n] for s in stacks), centers[:n], mp,
                                center_active=active[:n], **kw)
    B = active.shape[0]
    out = {}
    for part, tb, ts in (("state", big[2], small[2]),
                         ("data", big[1], small[1])):
        for (name, a), (_, b) in zip(_leaves(ts), _leaves(tb)):
            b = _rows(b, B, n)
            if a.shape == b.shape:
                same, d = _diff(a, b)
                if not same:
                    out[f"{part}.{name}"] = d
    return big, out


def fit_difference(state, data, config, n, n_iter):
    """Step 3: ``fit_batch`` of the whole batch and of its first ``n``
    blends from the same state."""
    big = state.active.shape[0]
    small_state = engine.map_tree(lambda x: _rows(x, big, n), state)
    small_data = engine.map_tree(lambda x: _rows(x, big, n), data)
    ob, lb = batch.fit_batch(state, data, config, n_iter)
    os_, ls = batch.fit_batch(small_state, small_data, config, n_iter)
    out = {}
    for field in ("seds", "morphs"):
        ref = getattr(ob, field)[0][:n]
        got = getattr(os_, field)[0]
        out[field] = float((got - ref).abs().max() / ref.abs().max())
    out["losses"] = float(((ls - lb[:, :n]).abs() / lb[:, :n].abs()).max())
    out["bitwise"] = bool(torch.equal(ls, lb[:, :n]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64,
                    help="blends fitted alone; the batch holds twice as many")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    stacks, centers, active = het_blends(2 * args.n)
    (config, data, state, _), init = init_difference(
        stacks, centers, active, args.n, device)
    result = dict(
        device=torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        n=args.n, batch=2 * args.n, init_leaves_differing=init,
        first_step=first_difference(state, data, config, args.n),
        fit=fit_difference(state, data, config, args.n, args.iters),
        iterations=args.iters)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
