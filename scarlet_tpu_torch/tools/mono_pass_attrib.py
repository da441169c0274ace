"""Attribute the cost of K1's monotonicity pass on the card to its parts.

The port of ``tools/mono_pass_attrib.py`` (the TPU tool) to Hopper.  It
times the seven instruction mixes of the pass
(:func:`scarlet_tpu_torch.ops.kernels.mono_pass_variant`,
``ops/csrc/attrib.cu``) at forced pass counts 8, 88, 200 and 352 on the
TPU tool's input: 128 blends of 10 slots of 59 x 59, lane-packed to
(128, 59, 590) float32 from ``RandomState(0)``, every slot with the
candidate-0 tables of box 59.  Every mix runs K1's own pass engine
(``ops/csrc/mono.cuh``: the taps in registers, the halo tiles, the
thread map of ``kernels.mono_geometry``), so ``full`` is K1's pass and
each other mix is K1's pass less the part it ablates.  Each count is the
least of ``--reps`` runs of :func:`queued_each` (CUDA events around three
calls queued behind a spin, so that they time the device alone); a
least-squares line over the counts gives, per mix, microseconds per pass
per blend (the slope over the batch), the overhead per blend and r^2.
Derived, the parts of K1's pass per pass per blend: its neighbour loads
(full - norolls), its convergence test (full - noreduce) and what a test
every 8 passes would save (full - unroll8).

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
import functools
import json
import sys

import numpy as np
import torch

from ..lite import engine
from ..ops import kernels as kn

S, K, B = 59, 10, 128
COUNTS = (8, 88, 200, 352)
N_CHECK = 16
# K1's forced pass counts beside full's (no morphology of the input exits
# before 48 passes at tol 0)
K1_COUNTS = (8, 16, 24, 32)


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


# spin cycles queued ahead of the timed calls (~10 ms at the H100's
# clocks), raised fourfold while the host has not queued them in time
QUEUE_CYCLES = 20_000_000


def queued_each(fns, cycles=QUEUE_CYCLES, tries=4):
    """Device milliseconds of each call of ``fns``, run back to back
    behind a spin kernel, a CUDA event after each.  The first event still
    waits on the spin once the last call is queued, so the events time
    the device alone: not the host's launch work, whose swing an event
    pair around one short call on an idle card also counts."""
    for _ in range(tries):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(fns) + 1)]
        torch.cuda._sleep(cycles)
        events[0].record()
        for fn, event in zip(fns, events[1:]):
            fn()
            event.record()
        queued = not events[0].query()
        torch.cuda.synchronize()
        if queued:
            return [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        cycles *= 4
    raise RuntimeError(f"the host did not queue {len(fns)} calls within "
                       f"a spin of {cycles // 4} cycles")


def _least_ms(fn, reps, calls=3):
    """Device milliseconds per call of ``fn``: the least of ``reps`` runs
    of :func:`queued_each` over ``calls`` calls, after a warm-up call.
    The least, since another context on the card only ever adds time."""
    fn()
    torch.cuda.synchronize()
    return min(sum(queued_each([fn] * calls)) / calls for _ in range(reps))


def _line(counts, ms):
    """A least-squares line of ``ms`` (one per pass count) over
    ``counts``: microseconds per pass and per blend, overhead per blend,
    r^2 and the times."""
    xs = np.array(counts, float)
    A = np.vstack([xs, np.ones_like(xs)]).T
    ys = np.asarray(ms, float) * 1e-3
    (tau, ovh), *_ = np.linalg.lstsq(A, ys, rcond=None)
    r2 = 1 - np.sum((A @ [tau, ovh] - ys) ** 2) / max(
        np.sum((ys - ys.mean()) ** 2), 1e-30)
    return {
        "us_per_pass_per_blend": float(tau / B * 1e6),
        "overhead_us_per_blend": float(ovh / B * 1e6),
        "r2": float(r2),
        "ms_at_counts": dict(zip(map(str, counts), map(float, ms))),
    }


def k1_over_full(device, rounds=31, counts=K1_COUNTS):
    """K1's own cost per pass (``monotonic_prox_packed`` at ``tol=0``,
    forced counts) beside ``full``'s, on the tool's input.  Each round
    queues K1 and full at every count back to back behind one spin
    (:func:`queued_each`), K1 first in even rounds and full first in odd
    ones, after a call that leaves the input in L2 for both; a line
    (:func:`_line`) over each one's least time per count, since another
    context on the card only ever adds time.  Returns {"k1": line,
    "full": line, "over_full": K1's slope over full's,
    "over_full_by_round": the same ratio of each round's lines}."""
    wsel, keepsel, wtab, keep = (torch.from_numpy(a).to(device)
                                 for a in slot_tables())
    packed = torch.from_numpy(packed_input()).to(device)
    idx = torch.zeros((B, K), dtype=torch.int32, device=device)
    calls = {
        "k1": lambda n: kn.monotonic_prox_packed(packed, idx, wtab, keep, S,
                                                 n, tol=0.0),
        "full": lambda n: kn.mono_pass_variant(packed, wsel, keepsel, "full",
                                               n),
    }
    for fn in calls.values():
        fn(counts[0])
    torch.cuda.synchronize()
    runs = {name: np.empty((rounds, len(counts))) for name in calls}
    for r in range(rounds):
        order = [(name, j) for j in range(len(counts))
                 for name in (("k1", "full") if r % 2 == 0 else
                              ("full", "k1"))]
        ms = queued_each([functools.partial(calls["k1"], counts[0])] + [
            functools.partial(calls[name], counts[j]) for name, j in order])
        for (name, j), t in zip(order, ms[1:]):
            runs[name][r, j] = t
    lines = {name: _line(counts, t.min(axis=0)) for name, t in runs.items()}

    def ratio(k1, full):
        return k1["us_per_pass_per_blend"] / full["us_per_pass_per_blend"]

    return dict(lines, over_full=ratio(lines["k1"], lines["full"]),
                over_full_by_round=[
                    ratio(_line(counts, runs["k1"][r]),
                          _line(counts, runs["full"][r]))
                    for r in range(rounds)])


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
    for mix in variants:
        ms = [_least_ms(lambda: kn.mono_pass_variant(
            packed, wsel, keepsel, mix, n), reps) for n in COUNTS]
        report[mix] = _line(COUNTS, ms)
        if log:
            log(f"mono_pass_attrib {mix:9s} "
                f"{report[mix]['us_per_pass_per_blend']:.5f} us/pass/blend, "
                f"overhead {report[mix]['overhead_us_per_blend']:.4f} "
                f"us/blend, r2 {report[mix]['r2']:.6f}; ms at {COUNTS}: "
                f"{[round(m, 4) for m in ms]}")

    sub = packed[:4].contiguous()
    idx = torch.zeros((sub.shape[0], K), dtype=torch.int32, device=device)
    ref = kn.monotonic_prox_packed(sub, idx, wtab, keep, S, N_CHECK, tol=0.0)
    got = kn.mono_pass_variant(sub, wsel, keepsel, "full", N_CHECK)
    max_diff = float((ref - got).abs().max())

    def slope(mix):
        return report[mix]["us_per_pass_per_blend"]

    # the parts of K1's pass (full is K1's pass, forced)
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
        "derived_of": "K1's pass (ops/csrc/mono.cuh mono_passes)",
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
