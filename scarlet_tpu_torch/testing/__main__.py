"""Regression-harness CLI: deblend the blend sets, store records, render
the dashboard.

    python -m scarlet_tpu_torch.testing --sets 1 2 3 4 --pipeline lite --plots

Mirrors the reference's pytest-driven testing/api.py entry (which requires
AWS credentials + --branch); everything here is local.  Runs on the CUDA
card; ``--cpu`` runs on the CPU instead.  Without a card and without
``--cpu`` it exits non-zero and writes no records.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

# where --baseline writes each set's records: this package's own
# baselines, never the JAX package's
BASELINE_DIR = pathlib.Path(__file__).parent / "baselines"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sets", type=int, nargs="+", default=[1, 2, 3, 4],
                   help="blend set ids (1-3 bundled; 4/5/6 generated at "
                        "the reference's curated scale; 7 very crowded)")
    p.add_argument("--pipeline", choices=["main", "lite", "stream"],
                   default="lite",
                   help="per-blend reference-parity pipeline (main), the "
                        "batched engine with host init (lite), or the "
                        "all-device stream path (stream)")
    p.add_argument("--branch", default=None,
                   help="store records under this branch name")
    p.add_argument("--root", default=None, help="store root (.regression)")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--plots", action="store_true",
                   help="render the dashboard after the run")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--baseline", action="store_true",
                   help="also write each set's records as the committed "
                        "baseline (scarlet_tpu_torch/testing/baselines/"
                        "set<id>.json)")
    p.add_argument("--detection", action="store_true",
                   help="also score the detection stage against each "
                        "set's truth catalog (completeness / false rate "
                        "/ match distance; api.detection_quality)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card; without "
                        "one the command fails)")
    p.add_argument("--data-dir", default="data",
                   help="the reference's data files (sets 1-3 and set 9's "
                        "cutouts; a set whose files are absent is empty)")
    args = p.parse_args(argv)

    from ..device import default_device
    from .api import deblend_and_measure

    try:
        device = default_device("cpu" if args.cpu else None)
    except RuntimeError as exc:
        print(f"python -m scarlet_tpu_torch.testing: {exc} (use --cpu)",
              file=sys.stderr)
        return 1

    results = deblend_and_measure(
        set_ids=args.sets, save=not args.no_save, branch=args.branch,
        root=args.root, pipeline=args.pipeline, max_iter=args.max_iter,
        device=device, data_dir=args.data_dir)
    for set_id, records in results.items():
        logls = [r["logL"] for r in records]
        iters = [r["iterations"] for r in records]
        print(json.dumps({
            "set": set_id,
            "n_blends": len(records),
            "median_logL": float(sorted(logls)[len(logls) // 2])
            if logls else None,
            "median_iterations": int(sorted(iters)[len(iters) // 2])
            if iters else None,
        }))

    det = None
    if args.detection:
        from .api import detection_quality

        import math

        det = detection_quality(set_ids=args.sets, root=args.root,
                                device=device, data_dir=args.data_dir)
        for set_id, summary in det.items():
            dist = summary["median_match_dist"]
            print(json.dumps({
                "set": set_id,
                "detection_completeness": round(summary["completeness"],
                                                4),
                "detection_false_rate": round(summary["false_rate"], 4),
                # null, not NaN: strict-JSON consumers (nothing matched)
                "median_match_dist_px": (None if math.isnan(dist)
                                         else round(dist, 3)),
            }))

    if args.baseline:
        import time

        BASELINE_DIR.mkdir(exist_ok=True)
        for set_id, records in results.items():
            out = BASELINE_DIR / f"set{set_id}.json"
            out.write_text(json.dumps(
                [{"timestamp": time.time(), "records": records}],
                indent=1, default=float))
            print(out)

    if args.plots:
        from .plots import render_dashboard

        written = render_dashboard(set_ids=args.sets, root=args.root,
                                   detection=det)
        for path in written:
            print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
