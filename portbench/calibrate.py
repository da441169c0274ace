"""Readings that set a cell's limits, many seeds in one process (each run
of the benchmark pays its whole set-up; this pays it once).

    python -m portbench.calibrate --workload <cell> --seeds 11 12 13 ...
        [--control] [--diagnose]

For each seed: the pool, every distinct call of the window once (the
timed path, as a run makes it), the same sample of records a run draws,
the plain reference on the sampled blends, and the compared numbers
(``check.numbers``).  ``--control`` reads the control beside it: the
port's own lower-precision path, its bfloat16 upload
(``upload_dtype=torch.bfloat16``), on the same calls and against the
same reference.  Beside each side's numbers, the widest per-blend gaps
(``tails``), from which the per-blend limits and their allowances are
set.  ``--diagnose`` adds, for the blends farthest from the
reference, the per-blend readings, the reference's own move on a 1e-7
relative change of the images, and the port's move when the same blends
are deblended as a batch of their own.  One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import check, generator, spec
from .run import Stream, log


def window_records(stream):
    """The records of every distinct call, by pool index."""
    out = {}
    for k in range(stream.distinct):
        sl = stream.slice(k)
        for j, rec in enumerate(stream(k)[0]):
            out[sl.start + j] = rec
    return out


def sampled(records, seed, size):
    sample = check.Sample(seed, size)
    failed = 0
    for i in sorted(records):
        failed += not check.finite_record(records[i])
        sample.offer(i, records[i])
    return sample.pairs(), failed


def per_blend(pairs, ref, top=6):
    rows = []
    for i, rec in pairs:
        r = ref[i]
        gap = abs(rec["logL"] - r["logL"]) / abs(r["logL"])
        fgap = float(np.sum(np.abs(rec["flux"] - r["flux"]))
                     / max(np.sum(np.abs(r["flux"])), 1e-30))
        rows.append(dict(index=i, logl_gap=gap, flux_gap=fgap,
                         logL=rec["logL"], ref_logL=r["logL"],
                         iterations=rec["iterations"],
                         ref_iterations=r["iterations"],
                         components=rec["n_components"],
                         retried=rec["retried"]))
    rows.sort(key=lambda r: -r["logl_gap"])
    return rows[:top]


def perturbed_pool(pool, seed, rel=1e-7):
    rng = np.random.default_rng([int(seed), 11])
    noise = rng.standard_normal(pool["images"].shape).astype(np.float32)
    return dict(pool, images=pool["images"] * (1 + rel * noise))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--diagnose", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    device = "cuda:0"
    cell = spec.load_cell(args.workload)
    size = cell.traffic["check_blends"]
    mpsf = generator.model_psf(cell.config["model_psf_sigma"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        pool = generator.make_pool(seed, cell.scene, cell.traffic)
        stream = Stream(cell, pool, device)
        records = window_records(stream)
        pairs, failed = sampled(records, seed, size)
        idx = sorted({i for i, _ in pairs})
        ref = check.reference_records(cell, pool, idx, mpsf, device)
        out = {"seed": seed, "cell": cell.name,
               "sound": check.numbers(pairs, ref, failed, cell.per_blend),
               "sound_tails": check.widest(pairs, ref, top=24)}
        if args.control:
            low = Stream(cell, pool, device, upload_dtype=torch.bfloat16)
            low_recs = window_records(low)
            lp = [(i, check.kept_fields(low_recs[i])) for i, _ in pairs]
            out["control"] = check.numbers(
                lp, ref, sum(not check.finite_record(r)
                             for r in low_recs.values()), cell.per_blend)
            out["control_tails"] = check.widest(lp, ref, top=24)
        if args.diagnose:
            worst = per_blend(pairs, ref)
            out["worst"] = worst
            wi = [w["index"] for w in worst]
            moved = check.reference_records(cell, perturbed_pool(pool, seed),
                                            wi, mpsf, device)
            out["reference_moves"] = [
                abs(moved[i]["logL"] - ref[i]["logL"]) / abs(ref[i]["logL"])
                for i in wi]
            sub = {k: v[idx] for k, v in pool.items()}
            own = Stream(cell, sub, device, blends_per_call=len(idx))
            own_recs = own(0)[0]
            pos = {i: j for j, i in enumerate(idx)}
            out["own_batch_moves"] = [
                abs(own_recs[pos[i]]["logL"] - records[i]["logL"])
                / abs(ref[i]["logL"]) for i in wi]
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out, default=float), flush=True)
        del stream
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
