"""Two checkouts of the repository against each other on one card: the
device time of the scene-assembly (K3) and gradient-gather (K4) kernels
at the lite fit's shapes.

Each run is a fresh process that imports ``scarlet_tpu_torch`` from one
checkout's root (building that checkout's kernels) and times, for each
band count of ``--bands``, ``kernels.scene_assembly`` and
``kernels.grad_gather`` on the same seeded inputs: 128 blends of 16
components, box 59, 58 x 48 scenes, boxes centered in the scene and
overhanging its edges, 10% of the slots off, the unpadded gradient as the
fit's inverse FFT leaves it (a strided crop, pad 0).  A kernel's time is
the median of ``--reps`` launches' device times (``torch.profiler``),
after a warm-up; each run also checks both kernels against their plain
versions (K3 and g_morph bit for bit).

The runs go in the order ``--order`` gives (indices into ``--roots``;
the default, parent, change, change, parent, parent, change, takes three
of each in turns), and the summary gives each checkout's median and
spread.  Run from a checkout's root, with a CUDA device::

    python -m scarlet_tpu_torch.tools.gather_ab --roots PARENT_DIR .

It prints one line per run and a JSON summary last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SHAPE = (128, 16, (58, 48), 59)     # B, K, (H, W), box


def _inputs(C, seed):
    import torch

    B, K, (H, W), box = SHAPE
    rng = np.random.default_rng(seed)
    seds = rng.uniform(0.1, 2, (B, K, C)).astype(np.float32)
    morphs = rng.uniform(0, 1, (B, K, box, box)).astype(np.float32)
    cy = rng.integers(0, H, (B, K, 1))
    cx = rng.integers(0, W, (B, K, 1))
    origins = np.concatenate([cy - box // 2, cx - box // 2], -1).astype(
        np.int32)
    on = rng.uniform(size=(B, K)) > 0.1
    full = rng.normal(size=(B, C, H + box - 1, W + box - 1)).astype(
        np.float32)
    dev = torch.device("cuda")
    t = [torch.from_numpy(x).to(dev) for x in (seds, morphs, origins, on,
                                               full)]
    y0, x0 = (box - 1) // 2, (box - 1) // 2
    return (*t[:4], t[4][..., y0:y0 + H, x0:x0 + W])


def _device_ms(fn, key, reps):
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
                 if e.device_type == DeviceType.CUDA and key in e.name]
        if times:
            return float(np.median(times)) / 1e3
    raise AssertionError(f"the profiler recorded no {key} launch")


def worker(root, bands, reps):
    """One run in this process, on the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from scarlet_tpu_torch.ops import build, kernels as kn

    assert os.path.abspath(kn.__file__).startswith(os.path.abspath(root))
    build.load()
    out = {}
    B, K, (H, W), box = SHAPE
    for C in bands:
        seds, m, org, on, grad = _inputs(C, 100 + C)
        shape = (C, H, W)
        got = kn.scene_assembly(seds, m, org, on, shape, box)
        ref = kn.scene_assembly_plain(seds, m, org, on, shape, box)
        gm = kn.grad_gather(grad, seds, m, org, 0)[1]
        rm = kn.grad_gather_plain(grad, seds, m, org, 0)[1]
        if not (torch.equal(got, ref) and torch.equal(gm, rm)):
            raise AssertionError(f"C={C}: a kernel differs from its plain "
                                 "version")
        out[C] = dict(
            scene_assembly=_device_ms(lambda: kn.scene_assembly(
                seds, m, org, on, shape, box), "scene_kernel", reps),
            grad_gather=_device_ms(lambda: kn.grad_gather(
                grad, seds, m, org, 0), "grad_kernel", reps))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--order", type=int, nargs="+",
                    default=[0, 1, 1, 0, 0, 1])
    ap.add_argument("--bands", type=int, nargs="+", default=[3, 5, 8])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.bands, args.reps)))
        return None
    runs = []
    for i in args.order:
        root = args.roots[i]
        # this file as a script: a checkout without the tool is measured
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               os.path.abspath(root), "--reps", str(args.reps), "--bands",
               *map(str, args.bands)]
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
        summary[root] = {
            C: {k: dict(median=float(np.median([r[C][k] for r in mine])),
                        runs=[r[C][k] for r in mine])
                for k in ("scene_assembly", "grad_gather")}
            for C in map(str, args.bands)}
    print(json.dumps(dict(shape=SHAPE, reps=args.reps, summary=summary)))
    return summary


if __name__ == "__main__":
    main()
