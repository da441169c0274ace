"""Two checkouts of the repository against each other on one card: the
host paths' costs that the host C library moves.

Each run is a fresh process that imports ``chip_smoke.py`` and
``scarlet_tpu_torch`` from one checkout's root and measures, with that
checkout's own code (the same functions as its ``chip_smoke.py``):

- the host init of the 128 host-path blends (``setup_blends``: s per 128,
  host clock);
- ``BlendPipeline`` on those blends (``hp_pipeline``): ``init_s`` and
  blends/min of the second timed run, which both checkouts' functions
  make (the first timed run also pays the calling process' first set-up
  at the full batch, 3.5-4.3 s of its ``setup_s`` against 0.6-0.9 s
  after; it is kept as ``pipeline_first_blends_per_min``);
- starlet_source's recipe with ``monotonic=True``
  (``ex_starlet_monotonic``: the host mask projection's share of the fit's
  wall, its calls, planes and seconds);
- digests of what must not move: the packed seeds of the 128 blends, the
  batched fit's per-blend iterations and final logL on them
  (``fit_batch_device_converged``), and the starlet fit's logL.

The runs go in the order ``--order`` gives (indices into ``--roots``;
the default, parent, change, change, parent, parent, change, takes three
of each in turns), one after the other, and the summary gives each
checkout's median and spread.  Run from a checkout's root, with a CUDA
device::

    python scarlet_tpu_torch/tools/native_ab.py --roots PARENT_DIR . \
        --out native_ab.json

It prints one line per run and a JSON summary last.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np


def _digest(tree):
    """sha256 (16 hex digits) of every array leaf of a tuple tree."""
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                add(y)
        elif hasattr(x, "detach"):
            h.update(x.detach().cpu().numpy().tobytes())
        elif x is not None:
            h.update(np.asarray(x).tobytes())

    add(tree)
    return h.hexdigest()[:16]


def one_run(root):
    """The measurements of one run, in this process, with ``root``'s
    code."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from scarlet_tpu_torch.testing import example_data

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    t0 = time.perf_counter()
    _, setup, init_s, _ = cs.setup_blends(dev)
    setup_s = time.perf_counter() - t0
    seeds_digest = _digest(tuple(setup[2]))
    out, _ = _fit(cs, setup)
    fit_digest = _digest((out.it, out.last_loss))
    _, hp = cs.hp_pipeline(dev, card, setup, init_s)
    runs = hp["runs"]
    mono = cs.ex_starlet_monotonic(dev, example_data.hsc_cosmos_35(), card)
    return dict(
        root=root, card=card, chip_smoke=os.path.abspath(cs.__file__),
        host_init_s_per_128=init_s * 128 / cs.N_BLENDS,
        setup_blends_s=setup_s,
        pipeline_init_s=runs[1]["init_s"],
        pipeline_blends_per_min=runs[1]["blends_per_min"],
        pipeline_wall_s=runs[1]["wall_s"],
        pipeline_first_blends_per_min=runs[0]["blends_per_min"],
        pipeline_runs=[{k: r[k] for k in ("init_s", "setup_s", "fit_s",
                                          "writeback_s", "wall_s",
                                          "blends_per_min")} for r in runs],
        mask_share=mono["share"], mask_fit_s=mono["fit_s"],
        mask_host_projection_s=mono["host_projection_s"],
        mask_calls=mono["calls"], mask_planes=mono["planes"],
        mask_iterations=mono["iterations"], mask_logL=mono["logL"],
        seeds_digest=seeds_digest, fit_digest=fit_digest)


def _fit(cs, setup):
    from scarlet_tpu_torch import parallel

    config, data, state = setup
    return parallel.fit_batch_device_converged(
        state, data, config, cs.MAX_ITER, check_every=cs.CHECK_EVERY)


KEYS = ("host_init_s_per_128", "pipeline_init_s", "pipeline_blends_per_min",
        "pipeline_wall_s", "pipeline_first_blends_per_min", "mask_share",
        "mask_host_projection_s", "mask_fit_s")


def summarize(results, roots):
    out = {}
    for k, root in enumerate(roots):
        mine = [r for r in results if r["root_index"] == k]
        out[root] = {key: dict(median=float(np.median([r[key] for r in mine])),
                               min=float(min(r[key] for r in mine)),
                               max=float(max(r[key] for r in mine)),
                               runs=[r[key] for r in mine])
                     for key in KEYS}
        out[root]["mask_calls"] = sorted({r["mask_calls"] for r in mine})
        out[root]["mask_planes"] = sorted({r["mask_planes"] for r in mine})
        for key in ("mask_logL", "seeds_digest", "fit_digest"):
            out[root][key] = sorted({r[key] for r in mine})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs=2, default=None,
                    help="the two checkouts' roots (parent, change)")
    ap.add_argument("--order", default="0,1,1,0,0,1")
    ap.add_argument("--out", default=None, help="JSON file of the runs")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run is not None:
        print(json.dumps(one_run(args.run)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.roots:
        print("native_ab: needs a CUDA device and --roots", file=sys.stderr)
        return 1
    results = []
    for k in (int(x) for x in args.order.split(",")):
        root = args.roots[k]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", root],
            capture_output=True, text=True, timeout=args.timeout)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"native_ab: the run of {root} failed "
                             f"({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(root_index=k, process_s=time.perf_counter() - t0)
        results.append(res)
        print(f"native_ab run {len(results)} ({root}): host init "
              f"{res['host_init_s_per_128']:.3f} s per 128, pipeline "
              f"init_s {res['pipeline_init_s']:.3f} s, "
              f"{res['pipeline_blends_per_min']:.1f} blends/min, mask share "
              f"{100 * res['mask_share']:.2f}% ({res['mask_calls']} calls, "
              f"{res['mask_host_projection_s']:.3f} of "
              f"{res['mask_fit_s']:.3f} s), seeds {res['seeds_digest']}, "
              f"fit {res['fit_digest']}, process {res['process_s']:.1f} "
              f"s, on {res['card']}", flush=True)
    summary = summarize(results, args.roots)
    summary["bit_for_bit"] = {
        key: len({r[key] for r in results}) == 1
        for key in ("seeds_digest", "fit_digest", "mask_logL")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(runs=results, summary=summary), f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
