"""One run of one cell of the port's benchmark.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's pool of blends from the seed, loads the port and
its kernels, and warms up every call the window makes; the window then
calls ``scarlet_tpu_torch.parallel.stream.deblend_device_stream`` on the
pool's slices back to back (a closed loop with one caller) for
``--seconds``; after it the sampled records are held against the plain
reference.  The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of a few whole calls
inside the window.  The numbers that decide ``correct`` close standard
error and the result line.

Exits with 2, and prints no result, without CUDA or with fewer cards
than the cell asks for, and with 3 if JAX or the JAX package is loaded
once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import check, counting, generator, spec
from .trace import Trace, breakdown, busy_us, from_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "scarlet_tpu")


def log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def process_start_epoch():
    """When this process started (seconds since the epoch), from
    ``/proc``; None where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


def loaded_forbidden():
    """Top-level names of the loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_report():
    """The card's name and power limit and the processes on it, as
    ``nvidia-smi`` reads them (a read; nothing is set)."""
    for query in (["--query-gpu=name,power.limit,clocks.max.sm",
                   "--format=csv,noheader"],
                  ["--query-compute-apps=pid,process_name,used_memory",
                   "--format=csv,noheader"]):
        try:
            out = subprocess.run(["nvidia-smi", *query], capture_output=True,
                                 text=True, timeout=30)
            log(f"nvidia-smi {query[0]}: {out.stdout.strip() or '(none)'}")
        except (OSError, subprocess.SubprocessError) as err:
            log(f"nvidia-smi {query[0]}: not read ({err})")


@dataclass
class Window:
    """What the window measured."""
    start: float = 0.0
    end: float = 0.0
    durations: list = field(default_factory=list)
    blends: int = 0
    attempted: int = 0
    failed: int = 0
    iterations_sum: float = 0.0
    iterations_n: int = 0
    trace: Trace = None
    traced_calls: int = 0
    traced_span_s: float = 0.0
    traced_busy_s: float = 0.0
    work: counting.Work = None
    breakdown: dict = None


@dataclass
class Run:
    """What a metric's reader reads: the cell, the setup time, the window,
    and the device's readings."""
    cell: spec.Cell
    setup_s: float
    window: Window
    fft_shape: tuple


class Stream:
    """The system under test: one ``deblend_device_stream`` call on the
    ``k``-th slice of the pool (``blends_per_call`` blends, in turn)."""

    def __init__(self, cell, pool, device, upload_dtype=None,
                 blends_per_call=None):
        from scarlet_tpu_torch.parallel import stream

        self.stream = stream
        self.cell, self.pool, self.device = cell, pool, device
        self.bpc = int(blends_per_call or cell.traffic["blends_per_call"])
        n = len(pool["images"])
        if n % self.bpc:
            raise ValueError(f"pool of {n} blends is not a multiple of "
                             f"{self.bpc} blends a call")
        self.distinct = n // self.bpc
        cfg = cell.config
        self.model_psf = generator.model_psf(cfg["model_psf_sigma"])
        self.kw = dict(box_size=cfg["box_size"], n_slots=cfg["n_slots"],
                       max_iter=cfg["max_iter"],
                       check_every=cfg["check_every"],
                       min_snr=cfg["min_snr"], e_rel=cfg["e_rel"],
                       upload_dtype=upload_dtype, device=device,
                       **cell.traffic.get("stream", {}))

    def slice(self, k):
        lo = (k % self.distinct) * self.bpc
        return slice(lo, lo + self.bpc)

    def __call__(self, k):
        import torch

        sl = self.slice(k)
        p = self.pool
        catalog = bool(self.cell.traffic["catalog"])
        result = self.stream.deblend_device_stream(
            p["images"][sl], p["variance"][sl], p["psfs"][sl],
            p["centers"][sl] if catalog else None, self.model_psf,
            center_active=p["active"][sl] if catalog else None, **self.kw)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        return result


def call_work(result, cell, pool, sl):
    """The :class:`counting.Work` of one call's result: iterations and
    active components from the records; the boxes' in-scene pixels from
    the final state's origins of the active slots (an overflow retry's
    blends from its own state); the catalog rows from the input catalog,
    or from the detected one."""
    import torch

    records, states, _, auxs = result
    states = states if isinstance(states, list) else [states]
    auxs = auxs if isinstance(auxs, list) else [auxs]
    S = int(cell.config["box_size"])
    _, H, W = cell.scene

    def pixels(state):
        org = state.origins[0].cpu().numpy()
        on = state.comp_active[0].cpu().numpy()
        return (counting.inscene_pixels(org, S, (H, W)) * on).sum(axis=1)

    px = pixels(states[0])
    if "retry_indices" in auxs[-1]:
        idx = np.asarray(auxs[-1]["retry_indices"])
        px[idx] = pixels(states[-1])[:idx.size]
    if cell.traffic["catalog"]:
        rows = pool["active"][sl].sum(axis=1)
    else:
        rows = torch.cat([a["center_active"] for a in auxs[:1]]).cpu(
        ).numpy().sum(axis=1)
    return counting.Work(
        iterations=np.array([r["iterations"] for r in records], np.float64),
        components=np.array([r["n_components"] for r in records],
                            np.float64),
        inscene_pixels=px.astype(np.float64),
        catalog_rows=rows.astype(np.float64))


def run_window(stream, seconds, sample, n_trace=0, trace_first=1):
    """Calls back to back until ``seconds`` have passed since the first
    started; calls ``trace_first`` to ``trace_first + n_trace - 1`` run
    under ``torch.profiler`` with the layer spans."""
    import torch

    w = Window()
    prof = None
    traced = []
    w.start = time.perf_counter()
    k = 0
    while time.perf_counter() - w.start < seconds or (
            n_trace and k < trace_first + n_trace):
        if n_trace and k == trace_first:
            from torch.profiler import ProfilerActivity, profile

            from .spans import layer_spans
            spans = layer_spans()
            spans.__enter__()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        sl = stream.slice(k)
        w.attempted += stream.bpc
        t0 = time.perf_counter()
        try:
            if prof is not None:
                with torch.profiler.record_function("layer:call"):
                    result = stream(k)
            else:
                result = stream(k)
        except Exception:  # a call that raises counts its blends as failed
            log(f"call {k} raised:\n{traceback.format_exc()}")
            w.failed += stream.bpc
            result = None
        t1 = time.perf_counter()
        w.durations.append(t1 - t0)
        w.end = t1
        if result is not None:
            records = result[0]
            for j, rec in enumerate(records):
                if not check.finite_record(rec):
                    w.failed += 1
                sample.offer(sl.start + j, rec)
                w.iterations_sum += rec["iterations"]
            w.iterations_n += len(records)
            w.failed += stream.bpc - len(records)
            w.blends += stream.bpc
            if prof is not None:
                traced.append((result, sl))
        if prof is not None and k == trace_first + n_trace - 1:
            prof.__exit__(None, None, None)
            spans.__exit__(None, None, None)
            w.trace = from_profiler(prof)
            prof = None
        k += 1
    if traced:
        w.traced_calls = len(traced)
        works = [call_work(r, stream.cell, stream.pool, sl)
                 for r, sl in traced]
        w.work = works[0]
        for extra in works[1:]:
            w.work = w.work + extra
        calls = [iv for iv in w.trace.host if iv.name == "layer:call"]
        lo = min(iv.start_us for iv in calls)
        hi = max(iv.end_us for iv in calls)
        w.traced_span_s = (hi - lo) * 1e-6
        ops = [op for op in w.trace.device_ops
               if op.end_us > lo and op.start_us < hi]
        w.traced_busy_s = busy_us(ops) * 1e-6
        w.breakdown = breakdown(w.trace, lo, hi)
    return w


def metric_values(metrics, run):
    out = {}
    for m in metrics:
        value = m.reader()(run)
        if value is None:
            log(f"{m.name}: nothing to read, left out")
            continue
        out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, root=".", overrides=None,
         upload_dtype=None):
    """Run one cell and print its result line.  ``device`` (tests only)
    skips the look for a card and runs there; ``overrides`` replace
    entries of the cell's config and traffic (``{"config": {...},
    "traffic": {...}}``, tests only); ``upload_dtype`` switches on the
    port's quantized upload (the control).  Returns the exit code."""
    args = parse(argv)
    started = process_start_epoch()
    t_main = time.time()
    import torch
    if started is not None:
        log(f"main entered {t_main - started:.3f} s after the process "
            "started")

    cell = spec.load_cell(args.workload, root=root)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA device: torch.cuda.is_available() is false")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} visible")
            return 2
        device = "cuda:0"
        log(f"torch and CUDA up at {time.time() - t_main:.3f} s")
        card_report()
    cuda = torch.device(device).type == "cuda"
    log(f"cell {cell.name}: seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}, device {device}")

    pool = generator.make_pool(args.seed, cell.scene, cell.traffic)
    log(f"pool of {len(pool['images'])} blends at "
        f"{time.time() - t_main:.3f} s")
    stream = Stream(cell, pool, device, upload_dtype)
    for k in range(stream.distinct):          # warm up every call's shapes
        stream(k)
        log(f"warm-up call {k} done at {time.time() - t_main:.3f} s")
    if args.trace and cuda:
        # the profiler's first start loads CUPTI: pay it in set-up
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum().item()
    if cuda:
        torch.cuda.synchronize()
    t_ready = time.time()
    setup_s = t_ready - (started if started is not None else t_main)

    sample = check.Sample(args.seed, cell.traffic["check_blends"])
    n_trace = int(cell.traffic["trace_calls"]) if args.trace else 0
    window = run_window(stream, args.seconds, sample, n_trace=n_trace)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window: {len(window.durations)} calls, {window.blends} blends in "
        f"{window.end - window.start:.3f} s; setup {setup_s:.3f} s")
    if window.durations:
        q = np.percentile(window.durations, [0, 25, 50, 75, 100])
        log("call seconds (min, quartiles, max): "
            + " ".join(f"{v:.4f}" for v in q))

    # the reference runs once the program's state is freed
    del stream
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    pairs = sample.pairs()
    ref = check.reference_records(cell, pool, sorted({i for i, _ in pairs}),
                                  generator.model_psf(
                                      cell.config["model_psf_sigma"]),
                                  device)
    values = check.numbers(pairs, ref, window.failed, cell.per_blend)
    widest = check.widest(pairs, ref, top=24)
    log(f"{len(pairs)} records compared; widest gaps: logL "
        + " ".join(f"{g:.3g}" for g in widest["logl"]) + "; flux "
        + " ".join(f"{g:.3g}" for g in widest["flux"]))
    correct, checks = check.judge(values, cell.limits)
    log(f"reference: {len(ref)} blends in "
        f"{time.perf_counter() - t_ref:.3f} s")

    from .reference import fft as ref_fft
    C, H, W = cell.scene
    psf = int(cell.config["psf_size"])
    fft_shape = tuple(ref_fft.minimal_same_fft_shape((C, H, W), (C, psf, psf),
                                                     axes=(1, 2)))
    run = Run(cell=cell, setup_s=setup_s, window=window, fft_shape=fft_shape)
    metrics = metric_values(cell.per_layer if args.trace
                            else cell.end_to_end, run)
    bad = loaded_forbidden()
    if bad:
        log(f"loaded once the window closed: {', '.join(bad)}")
        return 3
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if args.trace:
        dev["busy_s"] = window.traced_busy_s
        dev["window_s"] = window.traced_span_s
    result = {"correct": bool(correct), "attempted": int(window.attempted),
              "failed": int(window.failed), "metrics": metrics,
              "device": dev}
    if args.trace and window.breakdown is not None:
        result["breakdown"] = window.breakdown
    result["checks"] = checks
    for name in check.NUMBERS:
        if name not in checks:
            log(f"{name} = {values[name]!r} (not held)")
    for name, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"{name} = {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
