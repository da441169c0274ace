#!/usr/bin/env python3
"""Smoke test of scarlet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

1. Builds the CUDA kernels of ``scarlet_tpu_torch/ops/csrc`` with nvcc.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (128 blends x 16 components, box 59, 5 bands,
   58 x 48 scenes, with negative origins and an argmax tie), and times
   both with CUDA events.
3. Drives the main path: 128 generated blends (fixed seed), host
   initialization, one ``LiteBlend.fit`` on the card, then ``pack_blends``
   and ``fit_batch_device_converged`` for all 128; checks the results,
   that every kernel was launched, and that 4 blends refitted on the CPU
   (plain versions) end at the same logL.
4. Profiles 20 iterations of the batched fit: device time by kernel and
   the device's busy share of the wall time.
5. Prints one JSON line with the kernels, then, last, the device line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device, or outside
the repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 7
N_BLENDS = 128
MAX_ITER, CHECK_EVERY, E_REL = 100, 25, 1e-4
N_CPU = 4
CPU_RTOL = 1e-4          # final logL, card vs CPU (FFT and sum order)
GRAD_SED_RTOL = 1e-5     # g_sed vs plain, relative to sum |g * morph|

REPLACES = {
    "monotonic_prox": "scarlet_tpu/ops/pallas_kernels.py:204",
    "scene_assembly": "scarlet_tpu/ops/pallas_kernels.py:694",
    "grad_gather": "scarlet_tpu/ops/pallas_kernels.py:772",
}
SOURCES = {
    "monotonic_prox": "scarlet_tpu_torch/ops/csrc/mono.cu",
    "scene_assembly": "scarlet_tpu_torch/ops/csrc/scene.cu",
    "grad_gather": "scarlet_tpu_torch/ops/csrc/grad.cu",
}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
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


def kernel_phases(dev, card, setup):
    """Each kernel against its plain version on the card, on the main
    path's packed batch (its shapes, its morphologies, seds and origins,
    an argmax tie added).  Returns {name: {max_abs_err, limit, ms,
    plain_ms, ...}}."""
    import torch
    import torch.nn.functional as F
    from scarlet_tpu_torch.ops import kernels as kn

    config, data, state = setup
    C, H, W = config.scene_shape
    box = config.box_shapes[0][0]
    P = config.pad
    seds, origins, on = state.seds[0], state.origins[0], state.comp_active[0]
    B, K = on.shape
    shape = f"B={B} K={K} C={C} {H}x{W} box={box} pad={P}"
    out = {}

    # --- K1/K2: monotonicity on the box-masked initial morphologies ---
    n_iter = config.mono_n_iters[0]
    wt, kt = data.mono_weights[0], data.mono_keep[0]
    morphs = state.morphs[0] * data.box_masks[0]
    # an argmax tie in the 3x3 candidate window: the first maximum wins
    c0 = box // 2
    morphs[0, 0, c0 - 1:c0 + 2, c0 - 1:c0 + 2] = 2.0
    win = morphs[..., c0 - 1:c0 + 2, c0 - 1:c0 + 2].reshape(B, K, 9)
    idx = win.argmax(dim=-1)
    if int(idx[0, 0]) != 0:
        raise AssertionError(f"argmax tie picked {int(idx[0, 0])}, not 0")
    got = kn.monotonic_prox(morphs, idx, wt, kt, n_iter)
    ref = kn.monotonic_prox_plain(morphs, idx, wt, kt, n_iter)
    err = float((got - ref).abs().max())
    packed = morphs.transpose(-3, -2).reshape(B, box, K * box).contiguous()
    got_p = kn.monotonic_prox_packed(packed, idx, wt, kt, box, n_iter)
    ref_p = kn.monotonic_prox_packed_plain(packed, idx, wt, kt, box, n_iter)
    err_p = float((got_p - ref_p).abs().max())
    unpacked = got_p.reshape(B, box, K, box).transpose(-3, -2)
    err_layout = float((unpacked - got).abs().max())
    out["monotonic_prox"] = dict(
        max_abs_err=max(err, err_p, err_layout), limit=0.0,
        ms=time_ms(lambda: kn.monotonic_prox(morphs, idx, wt, kt, n_iter),
                   10),
        plain_ms=time_ms(
            lambda: kn.monotonic_prox_plain(morphs, idx, wt, kt, n_iter), 3),
        packed_ms=time_ms(lambda: kn.monotonic_prox_packed(
            packed, idx, wt, kt, box, n_iter), 10),
        also_replaces="scarlet_tpu/ops/pallas_kernels.py:253",
        shape=f"{shape} n_iter={n_iter}")

    # --- K3: scene assembly; the boxes overhang the scene edges ---
    m = state.morphs[0]
    if int(origins.min()) >= 0:
        raise AssertionError("no negative origin in the scene phase")
    got = kn.scene_assembly(seds, m, origins, on, (C, H, W), P)
    ref = kn.scene_assembly_plain(seds, m, origins, on, (C, H, W), P)
    out["scene_assembly"] = dict(
        max_abs_err=float((got - ref).abs().max()), limit=0.0,
        ms=time_ms(lambda: kn.scene_assembly(seds, m, origins, on,
                                             (C, H, W), P), 20),
        plain_ms=time_ms(lambda: kn.scene_assembly_plain(
            seds, m, origins, on, (C, H, W), P), 5),
        shape=shape)

    # --- K4: gradient gather from a padded scene gradient ---
    g = torch.Generator(device="cpu").manual_seed(SEED)
    gpad = F.pad(torch.randn(B, C, H, W, generator=g).to(dev), (P,) * 4)
    gs, gm = kn.grad_gather(gpad, seds, m, origins, P)
    rs, rm = kn.grad_gather_plain(gpad, seds, m, origins, P)
    # g_sed: a block reduction, summed in another order than torch's sum
    scale_s = kn.grad_gather_plain(gpad.abs(), seds, m, origins, P)[0]
    sed_err = float(((gs - rs).abs() / scale_s.clamp_min(1e-30)).max())
    if sed_err > GRAD_SED_RTOL:
        raise AssertionError(f"grad_gather g_sed off by {sed_err:.3g} of "
                             f"sum |g*morph| (limit {GRAD_SED_RTOL})")
    out["grad_gather"] = dict(
        max_abs_err=max(float((gm - rm).abs().max()),
                        float((gs - rs).abs().max())),
        limit=f"g_morph 0; g_sed {GRAD_SED_RTOL} x sum|g*morph|",
        g_morph_err=float((gm - rm).abs().max()),
        g_sed_rel_err=sed_err,
        ms=time_ms(lambda: kn.grad_gather(gpad, seds, m, origins, P), 20),
        plain_ms=time_ms(lambda: kn.grad_gather_plain(gpad, seds, m,
                                                      origins, P), 5),
        shape=shape)

    for name, res in out.items():
        limit = res["limit"]
        err = res["g_morph_err"] if name == "grad_gather" \
            else res["max_abs_err"]
        if err > (limit if isinstance(limit, float) else 0.0):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")
        log(f"kernel {name}: max_abs_err {res['max_abs_err']:.3g} (limit "
            f"{limit}), kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms [{res['shape']}] on {card}")
    return out


def build_blend(lite, d):
    weights = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = lite.LiteObservation(d["images"], d["variance"], weights,
                               d["psfs"], model_psf=model_psf)
    centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
               for r in d["catalog"]]
    sources = lite.init_all_sources_main(obs, centers, min_snr=50)
    sources = lite.parameterize_sources(sources, obs,
                                        lite.init_adaprox_component)
    return lite.LiteBlend(sources, obs)


def setup_blends(dev):
    """Generate the blends (fixed seed), initialize them on the host and
    pack them on the card.  Returns (single, (config, data, state), init
    seconds); ``single`` is a separately built copy of the first blend,
    for ``LiteBlend.fit``."""
    from scarlet_tpu_torch import lite, parallel
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(SEED)
    raw = [generate_blend(rng) for _ in range(N_BLENDS)]
    t0 = time.perf_counter()
    blends = [build_blend(lite, d) for d in raw]
    init_s = time.perf_counter() - t0
    n_comp = [len(b.components) for b in blends]
    log(f"host init of {N_BLENDS} blends: {init_s:.2f} s; components per "
        f"blend {min(n_comp)}..{max(n_comp)}")
    setup = parallel.pack_blends(blends, e_rel=E_REL, device=dev)
    config = setup[0]
    log(f"packed layout: box {config.box_shapes}, slots "
        f"{config.bucket_counts}, scene {config.scene_shape}, fft "
        f"{config.fft_shape}, pad {config.pad}, mono n_iter "
        f"{config.mono_n_iters}")
    return build_blend(lite, raw[0]), setup, init_s


def main_path(dev, card, single, setup, init_s):
    """The port's main path on the card.  Returns (launch counts,
    summary)."""
    import torch
    from scarlet_tpu_torch import parallel
    from scarlet_tpu_torch.ops import kernels as kn

    kn.reset_launch_counts()
    it1, logl1 = single.fit(MAX_ITER, e_rel=E_REL, device=dev)
    if not (np.isfinite(logl1) and it1 > 0
            and np.all(np.isfinite(single.loss))
            and logl1 > single.loss[0]):
        raise AssertionError(f"single-blend fit failed: it={it1}, "
                             f"logL {single.loss[0]} -> {logl1}")
    log(f"LiteBlend.fit on {dev}: {it1} iterations, logL "
        f"{single.loss[0]:.6g} -> {logl1:.6g}")

    config, data, state = setup
    times = []
    for _ in range(2):       # the first run also creates the cuFFT plans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, losses = parallel.fit_batch_device_converged(
            state, data, config, MAX_ITER, check_every=CHECK_EVERY)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kn.launch_counts()

    losses = losses.cpu().numpy()
    final = out.last_loss.cpu().numpy()
    its = out.it.cpu().numpy()
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(final))):
        raise AssertionError("non-finite logL in the batched fit")
    if not np.all(final > losses[0]):
        raise AssertionError(f"logL did not improve for blends "
                             f"{np.flatnonzero(final <= losses[0])}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    bpm = N_BLENDS / times[-1] * 60.0
    log(f"batched fit of {N_BLENDS} blends on {dev}: {len(losses)} "
        f"iterations run, per-blend iterations {its.min()}..{its.max()} (median "
        f"{np.median(its)}), median final logL {np.median(final):.6g}; "
        f"{times[-1]:.3f} s warm ({times[0]:.3f} s first) = {bpm:.1f} "
        f"blends/min on {card}")
    log(f"main-path kernel launches: {counts}")

    # the same first blends on the CPU: plain versions, same layout
    sel = list(range(N_CPU))
    cdata, cstate = parallel.select_blends(data, state, sel, device="cpu")
    t0 = time.perf_counter()
    cout, _ = parallel.fit_batch_device_converged(
        cstate, cdata, config, MAX_ITER, check_every=CHECK_EVERY)
    cpu_s = time.perf_counter() - t0
    cpu_final = cout.last_loss.numpy()
    rel = np.abs(cpu_final - final[sel]) / np.abs(final[sel])
    log(f"CPU refit of blends {sel} ({cpu_s:.1f} s): logL {cpu_final} vs "
        f"card {final[sel]}, max rel diff {rel.max():.3g} (limit "
        f"{CPU_RTOL}); iterations {cout.it.numpy()} vs {its[sel]}")
    if not rel.max() <= CPU_RTOL:
        raise AssertionError("CPU and card logL disagree")
    summary = dict(blends_per_min=bpm, fit_s=times[-1],
                   first_fit_s=times[0], init_s=init_s,
                   iterations_run=int(len(losses)))
    return counts, summary


def profile_fit(setup, n_iter=20):
    """Device time by kernel over ``n_iter`` iterations of the batched fit
    (``torch.profiler``), and the device's busy share of the wall time:
    the union of the kernels' intervals over the profiled window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from scarlet_tpu_torch.lite import engine

    config, data, state = setup
    engine.fit_scan(state, data, config, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.fit_scan(state, data, config, n_iter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: operator ranges projected onto the device
    # timeline (user annotations) repeat their kernels' time
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    if not kern:
        raise AssertionError("the profiler recorded no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, t in spans[1:]:
        if s > hi:
            busy_us += hi - lo
            lo, hi = s, t
        else:
            hi = max(hi, t)
    busy_us += hi - lo
    window_us = max(t for _, t in spans) - spans[0][0]
    log(f"profile of {n_iter} batched iterations: wall {wall * 1e3:.2f} ms, "
        f"kernels span {window_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100.0 * busy_us / 1e6 / wall:.1f}% of "
        f"wall, idle share {100.0 - 100.0 * busy_us / window_us:.1f}% of "
        "the kernels' span)")
    by_name = {}
    for e in kern:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    for name, (tot, n) in top:
        log(f"  {tot / n_iter / 1e3:9.4f} ms/iter {n / n_iter:6.1f} "
            f"calls/iter  {name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from scarlet_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: scarlet_tpu_torch not found next to this "
              f"script: {e}", file=sys.stderr)
        return 1

    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    path, secs, report = build.build()
    log(f"kernels built in {secs:.2f} s: {path.name}")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  " + line.strip())
    build.load()

    single, setup, init_s = setup_blends(dev)
    kres = kernel_phases(dev, card, setup)
    counts, summary = main_path(dev, card, single, setup, init_s)
    log(f"summary: {json.dumps(summary)}")
    profile_fit(setup)
    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name], launches=int(counts[name]),
             max_abs_err=res["max_abs_err"], ms=res["ms"],
             plain_ms=res["plain_ms"],
             **{k: v for k, v in res.items()
                if k not in ("max_abs_err", "ms", "plain_ms")})
        for name, res in kres.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
