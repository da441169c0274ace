"""Two checkouts of the repository against each other on one card: the
time of the wide-box projection kernels, K1 (``kernels.monotonic_prox``),
K5 (``kernels.prox_chain``) and K6 (``kernels.fused_morph_update``) on
boxes beyond ``kernels.mono_geometry`` (more than 73 pixels a side).

Each run is a fresh process that imports ``scarlet_tpu_torch`` from one
checkout's root (building that checkout's kernels) and, at each shape of
``SHAPES`` (B blends of K morphologies of an S x S box), times the three
wrappers on the same seeded inputs: peaked noisy profiles, box masks
cutting columns, a quarter of the slots gated off, thresholds, the
"angle" table at the box's full depth, tol 0.  A wrapper's time is the
median over ``--reps`` calls of CUDA events around one call, after a
warm-up (a call of several launches counts its host gaps); K1's is also
its kernels' device time (``torch.profiler``).  Each run checks the
three wrappers against their plain versions, bit for bit.  Then the fit
that runs them: ``FIT_BLENDS`` generated 5-band blends packed at box
``FIT_BOX`` (``stream.stream_setup``, 16 slots, mono_tol 0) fitted
``FIT_ITERS`` iterations by ``batch.fit_batch_device_converged`` under
the default configuration (K1), ``packed_prox_chain`` (K5) and
``fuse_morph`` (K6): ms per iteration on the host clock up to a
``torch.cuda.synchronize()``, each of ``FIT_REPS`` fits after a warm-up.

The runs go in the order ``--order`` gives (indices into ``--roots``;
the default, parent, change, change, parent, takes two of each in
turns), and the summary gives each checkout's median (fits: the median,
least and most over all its runs' fits).  ``--parts`` picks what a run
measures: ``kernels``, ``fits`` and ``slots``.  ``slots`` compares, in
one checkout, the register kernels of boxes up to 73 px (``mono.cu``)
with the wide engine (``wide.cu``) forced onto the same box-59 inputs,
``SLOT_ROUNDS`` rounds in turns of ``torch.profiler`` device time.  Run
from a checkout's root, with a CUDA device::

    python -m scarlet_tpu_torch.tools.wide_ab --roots PARENT_DIR .
    python -m scarlet_tpu_torch.tools.wide_ab --order 0 --parts slots

It prints one line per run and a JSON summary last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# (B, K, S): lone morphologies (the object tree's grown boxes and
# whole-frame seeds), chip_smoke's wide K5/K6 shape, and a box-81 fit
# chunk of 32 blends of 16 slots
SHAPES = ((1, 1, 81), (1, 1, 128), (1, 1, 150), (4, 8, 81), (4, 8, 101),
          (32, 16, 81))
NAMES = ("monotonic_prox", "prox_chain", "fused_morph_update")
FIT_BLENDS, FIT_BOX, FIT_ITERS, FIT_SEED, FIT_REPS = 32, 81, 20, 17, 3
FITS = ("default", "packed_prox_chain", "fuse_morph")
# (B, K, S) of the register-kernel comparison: the lite fit's box 59 at
# a bucket of 128 blends (R = 1) and at chip_smoke's wide K5/K6 count
SLOT_SHAPES = ((128, 16, 59), (4, 8, 59))
SLOT_ROUNDS = 5
PARTS = ("kernels", "fits", "slots")


def _inputs(B, K, S, seed):
    import torch
    from scarlet_tpu_torch.lite import engine

    dev = torch.device("cuda")
    w, keep, n_iter = engine.monotonicity_tables((S, S), 1, "angle")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:S, :S] - S // 2
    shape = (B, K, S, S)
    prof = np.exp(-(yy ** 2 + xx ** 2) / rng.uniform(20, 400, (B, K, 1, 1)))
    arrays = [w, keep, prof * (1 + 0.3 * rng.uniform(size=shape)),
              0.1 * rng.normal(size=shape), 0.05 * rng.normal(size=shape),
              0.01 * rng.uniform(size=shape), 0.01 * rng.uniform(size=shape),
              np.where(rng.uniform(size=(B, K)) > 0.5,
                       rng.uniform(0.01, 0.2, (B, K)), 0.0),
              np.full(B, 1e-2)]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]
    bm = torch.ones_like(t[2])
    bm[:, 1::3, :, :6] = 0.0
    gate = torch.from_numpy(rng.uniform(size=(B, K)) > 0.25).to(dev)
    gate.view(-1)[0] = True
    return n_iter, t, bm, gate


def _events_ms(fn, reps):
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_ms(fn, key, reps, wide=True):
    """Median device ms of the kernels named ``key`` over ``reps`` calls
    of ``fn``; ``wide=False`` leaves out the wide engine's kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and key in e.name
                 and (wide or "_wide" not in e.name)]
        if times:
            return float(np.median(times)) / 1e3
    raise AssertionError(f"the profiler recorded no {key} launch")


def _calls(B, K, S, seed):
    """The three wrappers' calls on seeded inputs: {name: call(f)}."""
    from scarlet_tpu_torch.lite import engine
    from scarlet_tpu_torch.ops import kernels as kn

    n_iter, (w, keep, m, g, m1, v, vh, thr, ds), bm, gate = _inputs(
        B, K, S, seed)
    stepped = (m + g) * bm
    idx = kn.candidate_index(stepped, 1)
    opt = engine.AdaproxState(m1, v, vh)
    return dict(
        monotonic_prox=(lambda f: f(stepped, idx, w, keep, n_iter)),
        prox_chain=(lambda f: f(m, stepped, idx, w, keep, thr, gate,
                                n_iter)),
        fused_morph_update=(lambda f: f(m, g, opt, gate, w, keep, bm, thr,
                                        ds, n_iter)[0]))


def worker(root, reps, parts):
    """One run in this process, on the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from scarlet_tpu_torch.ops import build, kernels as kn

    assert os.path.abspath(kn.__file__).startswith(os.path.abspath(root))
    build.load()
    out = {}
    for B, K, S in SHAPES if "kernels" in parts else ():
        calls = _calls(B, K, S, 1000 + S + B)
        res = {}
        for name, call in calls.items():
            got = call(getattr(kn, name))
            ref = call(getattr(kn, name + "_plain"))
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} at {(B, K, S)} differs from "
                                     "its plain version")
            res[name] = _events_ms(lambda: call(getattr(kn, name)), reps)
        res["monotonic_prox_device"] = _device_ms(
            lambda: calls["monotonic_prox"](kn.monotonic_prox),
            "mono_kernel_wide", reps)
        out[f"{B}x{K}x{S}"] = res
    if "fits" in parts:
        out["fit_ms_per_iteration"] = _fits()
    if "slots" in parts:
        out["slots"] = _slots(reps)
    return out


class _Wide:
    """Inside, every box takes the wide engine: ``mono_geometry``
    refuses it, as it refuses a box over 73 px."""

    def __enter__(self):
        from scarlet_tpu_torch.ops import kernels as kn

        def refuse(hb, wb):
            raise ValueError(f"box ({hb}, {wb}) sent to the wide engine")

        self.kn, self.real = kn, kn.mono_geometry
        kn.mono_geometry = refuse

    def __exit__(self, *exc):
        self.kn.mono_geometry = self.real


def _slots(reps):
    """At each of SLOT_SHAPES, the register kernels (``mono.cu``) and the
    wide engine forced onto the same inputs: bit for bit with each other
    and the plain version, then SLOT_ROUNDS rounds of each one's device
    ms (median of ``reps`` launches) in turns.  Returns {shape: {name:
    {"register": [ms...], "engine": [ms...]}, "R": ..., "P": ...}}."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn

    out = {}
    for B, K, S in SLOT_SHAPES:
        calls = _calls(B, K, S, 2000 + S + B)
        geo = kn._card_geometry(torch.device("cuda"), B * K, S, S)
        res = dict(R=geo.R, P=geo.P, threads=geo.threads,
                   register_P=kn.mono_geometry(S, S).P,
                   register_threads=kn.mono_geometry(S, S).threads)
        for name, call in calls.items():
            kern = getattr(kn, name)
            got = call(kern)
            with _Wide():
                kn.reset_launch_counts()
                eng = call(kern)
                counts = kn.launch_counts()
            if counts[f"{name}_wide"] != 1:
                raise AssertionError(f"{name} at {(B, K, S)}: the engine "
                                     f"did not launch ({counts})")
            ref = call(getattr(kn, name + "_plain"))
            if not (torch.equal(got, ref) and torch.equal(eng, ref)):
                raise AssertionError(f"{name} at {(B, K, S)}: register "
                                     "kernel, engine and plain differ")
            key = name.replace("monotonic_prox", "mono_kernel") \
                .replace("prox_chain", "chain_kernel") \
                .replace("fused_morph_update", "fused_kernel")
            times = dict(register=[], engine=[])
            for _ in range(SLOT_ROUNDS):
                times["register"].append(_device_ms(
                    lambda: call(kern), key, reps, wide=False))
                with _Wide():
                    times["engine"].append(_device_ms(
                        lambda: call(kern), key + "_wide", reps))
            res[name] = times
        out[f"{B}x{K}x{S}"] = res
    return out


def _fits():
    """ms per iteration of the box-FIT_BOX fit under each of FITS."""
    import dataclasses
    import time

    import torch
    from scarlet_tpu_torch import lite
    from scarlet_tpu_torch.parallel import batch, stream
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(FIT_SEED)
    blends = [generate_blend(rng, shape=(5, 58, 48))
              for _ in range(FIT_BLENDS)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((FIT_BLENDS, K, 2), np.int32)
    active = np.zeros((FIT_BLENDS, K), bool)
    for i, b in enumerate(blends):
        k = len(b["catalog"])
        centers[i, :k, 0] = np.round(b["catalog"]["y"])
        centers[i, :k, 1] = np.round(b["catalog"]["x"])
        active[i, :k] = True
    psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    config, data, state, _ = stream.stream_setup(
        *(np.stack([b[k] for b in blends])
          for k in ("images", "variance", "psfs")), centers, psf,
        center_active=active, box_size=FIT_BOX, n_slots=16,
        device=torch.device("cuda"), mono_tol=0.0)
    configs = dict(default=config,
                   packed_prox_chain=dataclasses.replace(
                       config, packed_prox_chain=True),
                   fuse_morph=dataclasses.replace(
                       config, packed_morphs=False, fuse_morph=True))
    out = {}
    for name in FITS:
        times = []
        for _ in range(1 + FIT_REPS):      # a warm-up, then FIT_REPS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch.fit_batch_device_converged(state, data, configs[name],
                                             FIT_ITERS, FIT_ITERS)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / FIT_ITERS)
        out[name] = times[1:]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--order", type=int, nargs="+", default=[0, 1, 1, 0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", nargs="+", choices=PARTS,
                    default=["kernels", "fits"])
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.reps, args.parts)))
        return None
    runs = []
    for i in args.order:
        root = args.roots[i]
        # this file as a script: a checkout without the tool is measured
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               os.path.abspath(root), "--reps", str(args.reps),
               "--parts", *args.parts]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=root)
        if proc.returncode != 0:
            raise RuntimeError(f"run on {root} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((root, res))
        print(json.dumps(dict(root=root, ms=res)), flush=True)
    summary = {}
    for root in args.roots:
        mine = [r for rt, r in runs if rt == root]
        if not mine:
            continue
        summary[root] = {
            shape: {k: float(np.median([r[shape][k] for r in mine]))
                    for k in (*NAMES, "monotonic_prox_device")}
            for shape in mine[0] if shape not in ("fit_ms_per_iteration",
                                                  "slots")}
        if "fit_ms_per_iteration" in mine[0]:
            summary[root]["fit_ms_per_iteration"] = {
                k: _spread([t for r in mine
                            for t in r["fit_ms_per_iteration"][k]])
                for k in FITS}
        if "slots" in mine[0]:
            summary[root]["slots"] = {
                shape: {name: {route: _spread(
                    [t for r in mine for t in r["slots"][shape][name][route]])
                    for route in ("register", "engine")} for name in NAMES}
                for shape in mine[0]["slots"]}
    print(json.dumps(dict(shapes=SHAPES, reps=args.reps, summary=summary)))
    return summary


def _spread(values):
    """Median, least and most of ``values``, and how many."""
    return dict(median=float(np.median(values)), min=float(min(values)),
                max=float(max(values)), n=len(values))


if __name__ == "__main__":
    main()
