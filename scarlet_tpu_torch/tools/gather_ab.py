"""Two checkouts of the repository against each other on one card: the
device time of the scene-assembly (K3) and gradient-gather (K4) kernels
at the lite fit's shapes.

Each run is a fresh process that imports ``scarlet_tpu_torch`` from one
checkout's root (building that checkout's kernels) and times, for each
band count of ``--bands``, ``kernels.scene_assembly`` and
``kernels.grad_gather`` on the same seeded inputs: by default 128 blends
of 16 components, box 59, 58 x 48 scenes (``--blends``, ``--components``,
``--box``, ``--scene H W``), boxes centered in the scene and overhanging
its edges, 10% of the slots off, the unpadded gradient as the fit's
inverse FFT leaves it (a strided crop, pad 0), or that gradient padded
by ``--pad`` on each side.  A kernel's time is the
median of ``--reps`` launches' device times (``torch.profiler``), after a
warm-up; each run also checks both kernels against their plain versions
(K3 and g_morph bit for bit) and records K4's route.  A checkout whose
``grad_geometry`` refuses the shape (a ValueError) is recorded with a
null time and the message.

The runs go in the order ``--order`` gives (indices into ``--roots``;
the default, parent, change, change, parent, parent, change, takes three
of each in turns), and the summary gives each root's median and spread.
A root may end in ``@`` and overrides of K4's geometry
(``kernels.grad_geometry``'s ``route`` and ``R``) or of K3's
(``kernels.scene_geometry``'s ``route``, written ``scene_route``), which
compares two geometries of one checkout.  ``--only scene`` (or
``grad``) times one kernel alone.  Run from a checkout's root, with a
CUDA device::

    python -m scarlet_tpu_torch.tools.gather_ab --roots PARENT_DIR .
    python -m scarlet_tpu_torch.tools.gather_ab --roots PARENT_DIR . \
        --bands 5 --blends 32 --box 81 --scene 80 80
    python -m scarlet_tpu_torch.tools.gather_ab --roots . .@route=tiled \
        --bands 3 5
    python -m scarlet_tpu_torch.tools.gather_ab --only scene --roots . \
        .@scene_route=staged --bands 3 5 8

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


def _inputs(C, seed, shape=SHAPE, pad=0):
    import torch
    import torch.nn.functional as F

    B, K, (H, W), box = shape
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
    grad = t[4][..., y0:y0 + H, x0:x0 + W]
    return (*t[:4], F.pad(grad, (pad,) * 4) if pad else grad)


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


def _geometry_overrides(spec):
    """({"route": ..., "R": ...}, {"route": ...}) of a root's
    ``@route=tiled,R=4,scene_route=staged``: K4's overrides and K3's."""
    grad, scene = {}, {}
    for item in filter(None, spec.split(",")):
        key, value = item.split("=")
        if key == "scene_route":
            scene["route"] = value
        else:
            grad[key] = int(value) if key == "R" else value
    return grad, scene


def worker(root, bands, reps, shape=SHAPE, pad=0, only=None):
    """One run in this process, on the checkout at ``root`` (with its
    ``@`` overrides); ``only`` "scene" or "grad" times that kernel
    alone."""
    root, _, spec = root.partition("@")
    sys.path.insert(0, os.path.abspath(root))
    import functools

    import torch
    from scarlet_tpu_torch.ops import build, kernels as kn

    assert os.path.abspath(kn.__file__).startswith(os.path.abspath(root))
    grad_over, scene_over = _geometry_overrides(spec)
    if grad_over:
        kn.grad_geometry = functools.partial(kn.grad_geometry, **grad_over)
    if scene_over:
        kn.scene_geometry = functools.partial(kn.scene_geometry,
                                              **scene_over)
    build.load()
    out = {}
    B, K, (H, W), box = shape
    for C in bands:
        seds, m, org, on, grad = _inputs(C, 100 + C, shape, pad)
        scene_shape = (C, H, W)
        res = {}
        if only != "grad":
            got = kn.scene_assembly(seds, m, org, on, scene_shape, box)
            ref = kn.scene_assembly_plain(seds, m, org, on, scene_shape, box)
            if not torch.equal(got, ref):
                raise AssertionError(f"C={C}: scene_assembly differs from "
                                     "its plain version")
            res["scene_assembly"] = _device_ms(lambda: kn.scene_assembly(
                seds, m, org, on, scene_shape, box), "scene_kernel", reps)
            geo = kn.scene_geometry(B, K, C, H, W)
            res["scene_route"] = getattr(geo, "route", None)
        if only == "scene":
            out[C] = res
            continue
        try:
            geo = kn.grad_geometry(B, K, C, H + 2 * pad, W + 2 * pad, box,
                                   box)
        except ValueError as e:
            out[C] = dict(res, grad_gather=None, route=None, error=str(e))
            continue
        gm = kn.grad_gather(grad, seds, m, org, pad)[1]
        rm = kn.grad_gather_plain(grad, seds, m, org, pad)[1]
        if not torch.equal(gm, rm):
            raise AssertionError(f"C={C}: grad_gather differs from its "
                                 "plain version")
        out[C] = dict(res, grad_gather=_device_ms(lambda: kn.grad_gather(
            grad, seds, m, org, pad), "grad_kernel", reps),
            route="staged" if geo.staged else getattr(geo, "route",
                                                      "direct"),
            R=getattr(geo, "R", None))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--order", type=int, nargs="+",
                    default=[0, 1, 1, 0, 0, 1])
    ap.add_argument("--bands", type=int, nargs="+", default=[3, 5, 8])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--blends", type=int, default=SHAPE[0])
    ap.add_argument("--components", type=int, default=SHAPE[1])
    ap.add_argument("--scene", type=int, nargs=2, default=SHAPE[2])
    ap.add_argument("--box", type=int, default=SHAPE[3])
    ap.add_argument("--pad", type=int, default=0)
    ap.add_argument("--only", choices=("scene", "grad"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shape = (args.blends, args.components, tuple(args.scene), args.box)
    if args.worker:
        print(json.dumps(worker(args.worker, args.bands, args.reps, shape,
                                args.pad, args.only)))
        return None
    runs = []
    for i in args.order:
        root = args.roots[i]
        # this file as a script: a checkout without the tool is measured
        path, at, spec = root.partition("@")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               os.path.abspath(path) + at + spec, "--pad", str(args.pad),
               "--reps", str(args.reps), "--bands",
               *map(str, args.bands), "--blends", str(args.blends),
               "--components", str(args.components), "--box", str(args.box),
               "--scene", *map(str, args.scene)] + (
                   ["--only", args.only] if args.only else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=path)
        if proc.returncode != 0:
            raise RuntimeError(f"run on {root} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((root, res))
        print(json.dumps(dict(root=root, ms=res)), flush=True)
    summary = {}
    for root in args.roots:
        mine = [r for rt, r in runs if rt == root]
        summary[root] = {}
        for C in map(str, args.bands):
            summary[root][C] = {k: mine[0][C].get(k) for k in (
                "route", "R", "scene_route") if k in mine[0][C]}
            for k in ("scene_assembly", "grad_gather"):
                if k not in mine[0][C]:
                    continue
                times = [r[C][k] for r in mine]
                summary[root][C][k] = dict(
                    median=None if None in times else float(np.median(times)),
                    runs=times)
    print(json.dumps(dict(shape=shape, pad=args.pad, reps=args.reps,
                          summary=summary)))
    return summary


if __name__ == "__main__":
    main()
