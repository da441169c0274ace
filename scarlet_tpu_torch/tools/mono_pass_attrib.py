"""Attribute the monotonicity pass's cost on the card to its parts.

The port of ``tools/mono_pass_attrib.py`` (the TPU tool) to Hopper.  It
times the seven microkernel variants of the pass
(:func:`scarlet_tpu_torch.ops.kernels.mono_pass_variant`,
``ops/csrc/attrib.cu``) at forced pass counts 8, 88, 200 and 352 on the
TPU tool's input: 128 blends of 10 slots of 59 x 59, lane-packed to
(128, 59, 590) float32 from ``RandomState(0)``, every slot with the
candidate-0 tables of box 59.  Each count is the median of ``--reps``
runs timed with CUDA events; a least-squares line over the counts gives,
per variant, microseconds per pass per blend (the slope over the batch),
the overhead per blend and r^2.  Derived, per pass per blend:
neighbour loads (full - norolls), the convergence test (full - noreduce)
and what a test every 8 passes saves (full - unroll8).

Cross-check: ``full`` at 16 forced passes must equal the production
kernel ``monotonic_prox_packed`` at ``n_iter=16, tol=0`` bit for bit (K1
stops only after a block that changed nothing, and after that every pass
is a no-op); the largest difference is ``full_vs_production_max_diff``.

Run with a CUDA device (exits non-zero without one)::

    python -m scarlet_tpu_torch.tools.mono_pass_attrib [--reps 9]
        [--variants full norolls ...]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..lite import engine
from ..ops import kernels as kn

S, K, B = 59, 10, 128
COUNTS = (8, 88, 200, 352)
N_CHECK = 16


def slot_tables(box=S, slots=K):
    """The candidate-0 monotonicity tables of a ``box`` morphology,
    gathered once per slot of the lane-packed layout: (wsel (8, box,
    slots*box), keepsel (box, slots*box)) float32, and the tables
    themselves (wtab (ncand, 8, box, box), keep (ncand, box, box))."""
    wtab, keep, _ = engine.monotonicity_tables((box, box), 1, "angle")
    wtab, keep = wtab.astype(np.float32), keep.astype(np.float32)
    wsel = np.concatenate([wtab[0]] * slots, axis=-1)
    keepsel = np.concatenate([keep[0]] * slots, axis=-1)
    return wsel, keepsel, wtab, keep


def packed_input(batch=B, box=S, slots=K):
    return np.random.RandomState(0).rand(batch, box, slots * box).astype(
        np.float32)


def _median_ms(fn, reps):
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


def attribute(device, reps=9, variants=None, log=None):
    """Time the variants on ``device`` (CUDA) and fit their per-pass
    slopes.  Returns the report dict the tool prints."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the attribution times a CUDA device, not {device}")
    wsel, keepsel, wtab, keep = (torch.from_numpy(a).to(device)
                                 for a in slot_tables())
    packed = torch.from_numpy(packed_input()).to(device)
    variants = list(variants or kn.MONO_PASS_MIXES)

    report = {}
    xs = np.array(COUNTS, float)
    A = np.vstack([xs, np.ones_like(xs)]).T
    for mix in variants:
        ms = [_median_ms(lambda: kn.mono_pass_variant(
            packed, wsel, keepsel, mix, n), reps) for n in COUNTS]
        ys = np.array(ms) * 1e-3
        (tau, ovh), *_ = np.linalg.lstsq(A, ys, rcond=None)
        r2 = 1 - np.sum((A @ [tau, ovh] - ys) ** 2) / max(
            np.sum((ys - ys.mean()) ** 2), 1e-30)
        report[mix] = {
            "us_per_pass_per_blend": float(tau / B * 1e6),
            "overhead_us_per_blend": float(ovh / B * 1e6),
            "r2": float(r2),
            "ms_at_counts": dict(zip(map(str, COUNTS), ms)),
        }
        if log:
            log(f"mono_pass_attrib {mix:9s} "
                f"{report[mix]['us_per_pass_per_blend']:.5f} us/pass/blend, "
                f"overhead {report[mix]['overhead_us_per_blend']:.4f} "
                f"us/blend, r2 {r2:.6f}; ms at {COUNTS}: "
                f"{[round(m, 4) for m in ms]}")

    sub = packed[:4].contiguous()
    idx = torch.zeros((sub.shape[0], K), dtype=torch.int32, device=device)
    ref = kn.monotonic_prox_packed(sub, idx, wtab, keep, S, N_CHECK, tol=0.0)
    got = kn.mono_pass_variant(sub, wsel, keepsel, "full", N_CHECK)
    max_diff = float((ref - got).abs().max())

    def slope(mix):
        return report[mix]["us_per_pass_per_blend"]

    derived = {}
    for name, a, b in (("neighbour_loads", "full", "norolls"),
                       ("convergence_test", "full", "noreduce"),
                       ("unroll8_saving", "full", "unroll8")):
        if a in report and b in report:
            derived[name] = slope(a) - slope(b)
    if {"norolls", "bf16"} <= report.keys():
        derived["norolls_over_bf16"] = slope("norolls") / slope("bf16")
    return {
        "metric": "mono_pass_attribution",
        "device": torch.cuda.get_device_name(device),
        "shape": f"B{B} x ({S},{K * S}) f32, {K} slots of {S}x{S}",
        "variants": report,
        "derived_us_per_pass_per_blend": derived,
        "full_vs_production_max_diff": max_diff,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--variants", nargs="*", default=None,
                    choices=kn.MONO_PASS_MIXES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mono_pass_attrib: needs a CUDA device", file=sys.stderr)
        return 1
    report = attribute("cuda", reps=args.reps, variants=args.variants,
                       log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
