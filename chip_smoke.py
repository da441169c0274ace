#!/usr/bin/env python3
"""Smoke test of scarlet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

1. Builds the CUDA kernels of ``scarlet_tpu_torch/ops/csrc`` with nvcc
   (one compiler process per source, all at once), prints each kernel's
   registers and spills, the projection kernels' resident blocks per SM
   at box 59, and K3's and K4's registers, spill, shared bytes, blocks
   per SM and grid at the host path's shapes (K4 also at the gradient
   padded by the scene pad, its direct route).
2. Holds K1-K4 against their plain PyTorch versions on the card at the
   host path's shapes (128 blends x 16 components, box 59, 5 bands,
   58 x 48 scenes, with negative origins and an argmax tie), and times
   both with CUDA events.  K4 runs as the fit calls it (the unpadded
   gradient, a strided crop, pad 0: the staged route), contiguous, and
   padded (the direct route), each held bit for bit in g_morph, to
   GRAD_SED_RTOL in g_sed, and bit for bit across two launches.
3. Drives the host path: 128 generated blends (fixed seed), host
   initialization, one ``LiteBlend.fit`` on the card, then ``pack_blends``
   and ``fit_batch_device_converged`` for all 128; checks the results,
   that its kernels were launched, and that 4 blends refitted on the CPU
   (plain versions) end at the same logL.  Profiles 20 iterations and
   counts the passes of their K1 launches; prints K1's, K3's, K4's and
   the padding ops' device time per iteration.
4. The device stream: 256 generated heterogeneous blends (the JAX
   bench's het cell: ``default_rng(42)``, box 59, 16 slots, cap 100,
   check every 25, chunks of 128, compaction at 50, overflow retry, bulk
   upload).  Holds K5 and K6, and K3 and K4 (K4 strided, contiguous and
   padded by the stream's pad), against their plain versions at the
   stream's shapes; runs ``deblend_device_stream`` once to warm up, then three
   times from host and three times from device-resident inputs; checks
   the records and that K1, K3 and K4 were launched; reruns 4 blends on
   the CPU (same discrete init decisions, same final logL); and fits
   chunk 0 three ways (default, ``packed_prox_chain`` = K5,
   ``fuse_morph`` = K6), which must agree.
5. T1, the attribution microkernels: holds each of the seven variants of
   ``mono_pass_variant`` (``ops/csrc/attrib.cu``) against its plain
   version at 8 passes on the tool's input (128 x (59, 590)), then runs
   ``scarlet_tpu_torch.tools.mono_pass_attrib`` (its path), checks that
   ``full`` equals K1 bit for bit and prints its JSON line; then fits K1's
   own cost per pass on the same input (``K1_COUNTS``) beside ``full``'s
   and estimates from it the passes each K1 launch of the profiled fit
   runs, beside the exact count.
6. Device detection: the het stream with ``centers=None`` (warm-up, then
   three runs from numpy and three device-resident), its overhead over
   the catalog stream, the host syncs per detection call, the card's
   catalogs against the CPU's for 32 blends, and one ``redetect=1`` run
   on the first 128 blends.
7. Prints one JSON line with the kernels, the card's name and power
   limit, then, last, the device line ``{"ok": true, "device": {...}}``.

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
# the H100's published peaks (NVIDIA's data sheet, SXM part): HBM3 bytes
# per second and float32 operations per second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1's own cost per pass, fitted over these forced pass counts on T1's
# input (no morphology there exits before 48 passes)
K1_COUNTS = (8, 16, 24, 32)
N_BLENDS = 128
MAX_ITER, CHECK_EVERY, E_REL = 100, 25, 1e-4
N_CPU = 4
CPU_RTOL = 1e-4          # final logL, card vs CPU (FFT and sum order)
GRAD_SED_RTOL = 1e-5     # g_sed vs plain, relative to sum |g * morph|

# the device stream: the JAX bench's het cell (bench.py:40, 48, 109-129,
# 294-308), uploaded in bulk from numpy
N_HET, HET_SEED = 256, 42
HET = dict(box_size=59, n_slots=16, max_iter=100, check_every=25, chunk=128,
           compact=50, retry_overflow=True, upload="bulk")
# het blends that a 1e-7 relative change of the images moves by < 4e-7 in
# logL over 30 CPU iterations (PERF.md): the card-vs-CPU rerun
CPU_BLENDS = [3, 7, 11, 15]
FUSED_MEDIAN_RTOL, FUSED_BLEND_RTOL = 1e-5, 1e-3
MAX_WORSE = 0.02    # share of stream blends that may end below their init
# the kernels of the default fit configuration (K5 and K6 run in the
# packed_prox_chain and fuse_morph configurations)
PATH_KERNELS = ("monotonic_prox", "scene_assembly", "grad_gather")

# T1 variants that may differ from their plain versions, as a share of
# the plain result's largest value: alu8's fused multiply-add rounds once
# where the plain version rounds twice (the multiply by 0.5 is exact, so
# they agree barring subnormals).  The other six, bf16 included (its plain
# version rounds each operation once to bf16, as the bf16x2 instructions
# do), bit for bit.
T1_BOUNDS = {"alu8": 1e-6}
# het blends whose catalogs the card and the CPU detect
DET_CPU_BLENDS = 32
REDETECT_BLENDS = 128

REPLACES = {
    "monotonic_prox": "scarlet_tpu/ops/pallas_kernels.py:204",
    "prox_chain": "scarlet_tpu/ops/pallas_kernels.py:399",
    "fused_morph_update": "scarlet_tpu/ops/pallas_kernels.py:612",
    "scene_assembly": "scarlet_tpu/ops/pallas_kernels.py:694",
    "grad_gather": "scarlet_tpu/ops/pallas_kernels.py:772",
    "mono_pass_variant": "tools/mono_pass_attrib.py:193",
}
SOURCES = {
    "monotonic_prox": "scarlet_tpu_torch/ops/csrc/mono.cu",
    "prox_chain": "scarlet_tpu_torch/ops/csrc/mono.cu",
    "fused_morph_update": "scarlet_tpu_torch/ops/csrc/mono.cu",
    "scene_assembly": "scarlet_tpu_torch/ops/csrc/scene.cu",
    "grad_gather": "scarlet_tpu_torch/ops/csrc/grad.cu",
    "mono_pass_variant": "scarlet_tpu_torch/ops/csrc/attrib.cu",
}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, nops):
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``nops``
    float32 operations: the larger of the two over the H100's published
    peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(nops))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def mono_passes_run(morphs, idx, wt, kt, n_iter, tol, running=None,
                    scale=1.0):
    """The passes each morphology of (..., K, hb, wb) runs under the
    projection's exit rule (blocks of 4, the last two compared), from
    the plain passes: an integer tensor (..., K).  ``running`` (..., K)
    bool: morphologies that run at all (the others run 0)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn

    w, keep = wt[idx.long()], kt[idx.long()] > 0.5
    x = morphs
    run = torch.ones(morphs.shape[:-2], dtype=torch.bool,
                     device=morphs.device) if running is None \
        else running.clone()
    passes = torch.zeros(morphs.shape[:-2], dtype=torch.int64,
                         device=morphs.device)
    t = 0
    while t < n_iter and bool(run.any()):
        for _ in range(kn.MONO_UNROLL - 1):
            x = kn._mono_pass(x, morphs, w, keep, scale)
        new = kn._mono_pass(x, morphs, w, keep, scale)
        changed = ((new - x).abs().amax(dim=(-2, -1)) > tol) if tol > 0 \
            else (new != x).any(dim=-1).any(dim=-1)
        passes += kn.MONO_UNROLL * run
        run &= changed
        x = new
        t += kn.MONO_UNROLL
    return passes


def mono_ops(passes, idx, wt):
    """Float32 operations of the projection's passes: per pass and pixel,
    a multiply and an add for each nonzero tap of the selected table and
    the min against x0 (the scale multiply is off at min_gradient 0)."""
    per_pixel = 2 * (wt != 0).sum(dim=1) + 1              # (ncand, hb, wb)
    per_morph = per_pixel.sum(dim=(-2, -1))[idx.long()]   # (..., K)
    return float((passes * per_morph).sum())


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


def device_ms(fn, key, reps=20):
    """Median device time in ms of the kernels whose name holds ``key``
    over ``reps`` runs of ``fn`` (``torch.profiler``), after a warm-up run:
    the kernel's own time, without the host's launch gaps that CUDA events
    around a call of a few tens of microseconds also count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):     # the profiler has come back empty-handed once
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and key in e.name]
        if times:
            return float(np.median(times)) / 1e3
    raise AssertionError(f"the profiler recorded no {key} launch")


def in_scene_pixels(origins, on, hb, wb, H, W):
    """Pixels of the active boxes that lie inside the (H, W) scene."""
    import torch

    oy, ox = origins[..., 0].long(), origins[..., 1].long()
    rows = (torch.clamp(oy + hb, max=H) - torch.clamp(oy, min=0)).clamp_min(0)
    cols = (torch.clamp(ox + wb, max=W) - torch.clamp(ox, min=0)).clamp_min(0)
    return int((rows * cols * on).sum())


def strided_gradient(B, C, H, W, fft_shape, dev):
    """A seeded (B, C, H, W) gradient that is the centered crop of a
    ``fft_shape`` array, as the engine's inverse FFT returns it."""
    import torch
    from scarlet_tpu_torch.ops import fft

    g = torch.Generator(device="cpu").manual_seed(SEED)
    full = torch.randn(B, C, *fft_shape, generator=g).to(dev)
    return fft.centered(full, (H, W), axes=(-2, -1))


def scene_check(seds, m, origins, on, scene_shape, P):
    """K3 against its plain version: bit for bit, timed (``ms`` the
    kernel's device time, ``event_ms`` CUDA events around the call, as
    the earlier runs timed it); the bound counts the output and the
    in-scene pixels of the active boxes."""
    from scarlet_tpu_torch.ops import kernels as kn

    C, H, W = scene_shape
    hb, wb = m.shape[-2:]
    got = kn.scene_assembly(seds, m, origins, on, scene_shape, P)
    ref = kn.scene_assembly_plain(seds, m, origins, on, scene_shape, P)
    px = in_scene_pixels(origins, on, hb, wb, H, W)
    # a multiply and an add per band and in-scene pixel of each active box
    return dict(
        **bound(nbytes(seds, origins, on, got) + 4 * px, 2.0 * C * px),
        in_scene_active_pixels=px,
        max_abs_err=float((got - ref).abs().max()), limit=0.0,
        ms=device_ms(lambda: kn.scene_assembly(seds, m, origins, on,
                                               scene_shape, P),
                     "scene_kernel"),
        event_ms=time_ms(lambda: kn.scene_assembly(seds, m, origins, on,
                                                   scene_shape, P), 20),
        plain_ms=time_ms(lambda: kn.scene_assembly_plain(
            seds, m, origins, on, scene_shape, P), 5))


def grad_check(grad, seds, m, origins, P):
    """K4 against its plain version on the unpadded (strided) gradient
    with pad 0, the same contiguous, and padded by P: g_morph bit for
    bit, g_sed within GRAD_SED_RTOL of sum |g * morph| and the same bits
    in two launches.  The main numbers are the strided call's (``ms`` its
    device time, ``event_ms`` CUDA events around the call); the bound
    counts the unpadded gradient, the morphs in and the g_morphs out."""
    import torch.nn.functional as F
    from scarlet_tpu_torch.ops import kernels as kn

    B, C, H, W = grad.shape
    K, hb, wb = m.shape[-3:]
    calls = {"strided": (grad, 0), "contiguous": (grad.contiguous(), 0),
             "padded": (F.pad(grad, (P,) * 4), P)}
    runs = {}
    for name, (g, p) in calls.items():
        gs, gm = kn.grad_gather(g, seds, m, origins, p)
        rs, rm = kn.grad_gather_plain(g, seds, m, origins, p)
        scale = kn.grad_gather_plain(g.abs(), seds, m, origins, p)[0]
        sed_err = float(((gs - rs).abs() / scale.clamp_min(1e-30)).max())
        again = kn.grad_gather(g, seds, m, origins, p)
        same = bool((again[0] == gs).all() and (again[1] == gm).all())
        if sed_err > GRAD_SED_RTOL or not same:
            raise AssertionError(
                f"grad_gather ({name}) g_sed off by {sed_err:.3g} of sum "
                f"|g*morph| (limit {GRAD_SED_RTOL}); repeat equal {same}")
        runs[name] = dict(
            grad_route="staged" if kn.grad_geometry(
                B, K, C, *g.shape[-2:], hb, wb).staged
            else "direct", pad=p,
            g_morph_err=float((gm - rm).abs().max()),
            g_sed_abs_err=float((gs - rs).abs().max()),
            g_sed_rel_err=sed_err, repeat_bitwise=same,
            ms=device_ms(lambda: kn.grad_gather(g, seds, m, origins, p),
                         "grad_kernel"),
            event_ms=time_ms(lambda: kn.grad_gather(g, seds, m, origins, p),
                             20))
        if name == "strided":
            outs = (gs, gm)
    main = runs["strided"]
    return dict(
        # g_sed and g_morph: a multiply and an add per band and pixel each
        **bound(nbytes(grad, seds, m, origins, *outs),
                4.0 * B * K * C * hb * wb),
        max_abs_err=max(max(r["g_morph_err"], r["g_sed_abs_err"])
                        for r in runs.values()),
        limit=f"g_morph 0; g_sed {GRAD_SED_RTOL} x sum|g*morph|",
        g_morph_err=max(r["g_morph_err"] for r in runs.values()),
        g_sed_rel_err=max(r["g_sed_rel_err"] for r in runs.values()),
        ms=main["ms"], event_ms=main["event_ms"],
        grad_route=main["grad_route"],
        plain_ms=time_ms(lambda: kn.grad_gather_plain(grad, seds, m,
                                                      origins, 0), 5),
        calls=runs)


def kernel_phases(dev, card, setup):
    """Each kernel against its plain version on the card, on the main
    path's packed batch (its shapes, its morphologies, seds and origins,
    an argmax tie added).  Returns {name: {max_abs_err, limit, ms,
    plain_ms, ...}}."""
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
    passes = mono_passes_run(morphs, idx, wt, kt, n_iter, 0.0)
    out["monotonic_prox"] = dict(
        **bound(2 * nbytes(morphs) + nbytes(idx, wt, kt),
                mono_ops(passes, idx, wt)),
        mean_passes=float(passes.double().mean()),
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
    out["scene_assembly"] = dict(
        **scene_check(seds, m, origins, on, (C, H, W), P), shape=shape)

    # --- K4: gradient gather, as the fit calls it (the unpadded gradient,
    # a strided crop of a larger array as the inverse FFT returns it, pad
    # 0), then contiguous, then padded by P (the direct route) ---
    grad = strided_gradient(B, C, H, W, config.fft_shape, dev)
    out["grad_gather"] = dict(**grad_check(grad, seds, m, origins, P),
                              shape=shape)

    for name, res in out.items():
        limit = res["limit"]
        err = res["g_morph_err"] if name == "grad_gather" \
            else res["max_abs_err"]
        if err > (limit if isinstance(limit, float) else 0.0):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")
        timing = f"{res['ms']:.4f} ms" if "event_ms" not in res else \
            f"{res['ms']:.4f} ms device ({res['event_ms']:.4f} ms events)"
        log(f"kernel {name}: max_abs_err {res['max_abs_err']:.3g} (limit "
            f"{limit}), kernel {timing}, plain {res['plain_ms']:.4f} ms "
            f"[{res['shape']}] on {card}")
    log_grad_calls(out["grad_gather"], card)
    return out


def log_grad_calls(res, card):
    """K4's calls, one line each; both routes must have run."""
    for name, r in res["calls"].items():
        log(f"  grad_gather {name} (pad {r['pad']}, {r['grad_route']} "
            f"route): g_morph err {r['g_morph_err']:.3g}, g_sed rel err "
            f"{r['g_sed_rel_err']:.3g}, two launches bitwise "
            f"{r['repeat_bitwise']}, {r['ms']:.4f} ms device "
            f"({r['event_ms']:.4f} ms events) on {card}")
    routes = {r["grad_route"] for r in res["calls"].values()}
    if routes != {"staged", "direct"}:
        raise AssertionError(f"grad_gather ran the routes {routes} only")


def log_gather_info(B, K, C, H, W, hb, wb, P, card):
    """K3's and K4's registers, spill, shared bytes and blocks per SM at
    the fit's shapes, and K4's at the gradient padded by P."""
    from scarlet_tpu_torch.ops import kernels as kn

    for hw, pad in (((H, W), 0), ((H + 2 * P, W + 2 * P), P)):
        for name, i in kn.gather_kernel_info(B, K, C, *hw, hb, wb).items():
            if name == "scene_assembly" and pad:
                continue
            route = f", {i['route']} route, G={i['G']}" \
                if "route" in i else f", XV={i['XV']}"
            log(f"{name} at B={B} K={K} C={C} {hw[0]}x{hw[1]} (pad {pad})"
                f"{route}: grid {tuple(i['grid'])}, {i['threads']} threads,"
                f" {i['registers']} registers, {i['spill_bytes']} B local "
                f"(spill) per thread, {i['smem_bytes']} B shared, "
                f"{i['blocks_per_sm']} blocks resident per SM on {card}")


def build_blend(lite, d):
    weights = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = lite.LiteObservation(d["images"], d["variance"], weights,
                               d["psfs"], model_psf=model_psf, device="cpu")
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
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "host path")
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


def device_busy(prof):
    """(device kernel events, busy us, us from the first kernel's start to
    the last one's end) of a ``torch.profiler`` run: the union of the
    kernels' intervals."""
    from torch.autograd import DeviceType

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
    return kern, busy_us, max(t for _, t in spans) - spans[0][0]


def profile_fit(setup, n_iter=20):
    """Device time by kernel over ``n_iter`` iterations of the batched fit
    (``torch.profiler``), and the device's busy share of the wall time:
    the union of the kernels' intervals over the profiled window.
    Returns, per K1, K3, K4 and the padding ops (``F.pad``), device ms
    per iteration and launches (ops) per iteration, K1's to K4's ms per
    launch."""
    import torch
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
    kern, busy_us, window_us = device_busy(prof)
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
    per_iter = {}
    for label, key in (("K1", "mono_kernel"), ("K3", "scene_kernel"),
                       ("K4", "grad_kernel")):
        hits = [(t, n) for name, (t, n) in by_name.items() if key in name]
        per_iter[label] = dict(
            ms_per_iteration=sum(t for t, _ in hits) / n_iter / 1e3,
            launches_per_iteration=sum(n for _, n in hits) / n_iter,
            ms_per_launch=sum(t for t, _ in hits)
            / max(sum(n for _, n in hits), 1) / 1e3)
    # padding ops and the device time of their kernels
    pads = [e for e in prof.key_averages()
            if e.key in ("aten::constant_pad_nd", "aten::pad")]
    pad_us = sum(getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0.0) for e in pads)
    per_iter["pad"] = dict(
        ms_per_iteration=pad_us / n_iter / 1e3,
        calls_per_iteration=max((e.count for e in pads), default=0) / n_iter)
    log("per fit iteration: " + "; ".join(
        f"{k} {v['ms_per_iteration']:.4f} ms device ("
        + (f"{v['launches_per_iteration']:.1f} launches, "
           f"{v['ms_per_launch']:.4f} ms each)" if k != "pad" else
           f"{v['calls_per_iteration']:.1f} pad ops)")
        for k, v in per_iter.items()))
    return per_iter


def fit_k1_work(setup, n_iter=20):
    """What the K1 launches of the profiled iterations do, from their own
    inputs (the same iterations, rerun with each launch's input handed to
    the plain exit rule): mean passes per morphology, and the bound of
    the mean launch (``bound``)."""
    import torch
    from scarlet_tpu_torch.lite import engine
    from scarlet_tpu_torch.ops import kernels as kn

    config, data, state = setup
    orig = kn.monotonic_prox
    runs = []

    def counted(morphs, idx, wt, kt, n, min_gradient=0.0, tol=0.0):
        passes = mono_passes_run(morphs, idx, wt, kt, n, tol,
                                 scale=1.0 - min_gradient)
        runs.append((float(passes.double().mean()),
                     2 * nbytes(morphs) + nbytes(idx, wt, kt),
                     mono_ops(passes, idx, wt)))
        return orig(morphs, idx, wt, kt, n, min_gradient, tol)

    # the wrapper is the module's monotonic_prox while it runs, so the
    # kernel's launch counter is its own: these launches count nowhere
    counted.launches = 0
    kn.monotonic_prox = counted
    try:
        engine.fit_scan(state, data, config, n_iter)
        torch.cuda.synchronize()
    finally:
        kn.monotonic_prox = orig
    passes, nb, ops = (float(np.mean(c)) for c in zip(*runs))
    return dict(mean_passes=passes, launches=len(runs), **bound(nb, ops))


def make_het():
    """bench.py's ``make_heterogeneous``: N_HET generated blends packed to
    one catalog layout (numpy)."""
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(HET_SEED)
    blends = [generate_blend(rng) for _ in range(N_HET)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((N_HET, K, 2), np.int32)
    active = np.zeros((N_HET, K), bool)
    for i, b in enumerate(blends):
        k = len(b["catalog"])
        centers[i, :k, 0] = np.round(b["catalog"]["y"])
        centers[i, :k, 1] = np.round(b["catalog"]["x"])
        active[i, :k] = True
    return dict(images=np.stack([b["images"] for b in blends]),
                variance=np.stack([b["variance"] for b in blends]),
                psfs=np.stack([b["psfs"] for b in blends]),
                centers=centers, active=active)


def model_psf():
    from scarlet_tpu_torch import lite

    return lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)


def het_setup(dev, het, sel, **kw):
    from scarlet_tpu_torch.parallel import stream

    return stream.stream_setup(
        het["images"][sel], het["variance"][sel], het["psfs"][sel],
        het["centers"][sel], model_psf(), center_active=het["active"][sel],
        box_size=HET["box_size"], n_slots=HET["n_slots"], device=dev, **kw)


def stream_kernel_phases(dev, card, het):
    """K5 and K6 against their plain versions on chunk 0 of the stream
    (its morphologies, box masks, seds and noise), with some gates off,
    nonzero thresholds, an argmax tie, and blends at their first
    iteration beside later ones."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.optim import AdaproxState

    config, data, state, _ = het_setup(dev, het, slice(0, HET["chunk"]))
    wt, kt = data.mono_weights[0], data.mono_keep[0]
    n_iter = config.mono_n_iters[0]
    morphs, masks, seds = state.morphs[0], data.box_masks[0], state.seds[0]
    B, K, hb, wb = morphs.shape
    shape = (f"B={B} K={K} box={hb} C={seds.shape[-1]} "
             f"{config.scene_shape[1]}x{config.scene_shape[2]} "
             f"n_iter={n_iter}")
    gen = torch.Generator().manual_seed(SEED)

    def rand(scale, like=morphs):
        return (scale * torch.randn(like.shape, generator=gen)).to(dev)

    grads = rand(0.1)
    opt = AdaproxState(rand(0.05), rand(0.01).abs(), rand(0.01).abs())
    gate = state.comp_active[0] & (torch.rand(B, K, generator=gen)
                                   > 0.2).to(dev)
    # the packed branch's cutoff at bg_thresh 0.25: nonzero thresholds
    thr = ((0.25 * data.bg_rms)[:, None, :]
           / seds.clamp_min(config.floor)).amin(dim=-1)
    it = torch.arange(B, device=dev) % 3
    ds = torch.where(it > 0, 1.0, 0.1) * config.morph_step
    stepped = ((morphs + grads) * masks).contiguous()
    c = hb // 2
    stepped[0, 0, c - 1:c + 2, c - 1:c + 2] = 2.0
    idx = kn.candidate_index(stepped, 1)
    if int(idx[0, 0]) != 0 or not (thr > 0).any() or bool(gate.all()) \
            or not bool((it == 0).any()):
        raise AssertionError("K5/K6 inputs miss a tie, a threshold, a "
                             "gated-off slot or a first iteration")
    out = {}

    chain = lambda f, tol: f(morphs, stepped, idx, wt, kt, thr, gate,  # noqa
                             n_iter, 0.0, config.floor, tol=tol)
    err = max(float((chain(kn.prox_chain, tol)
                     - chain(kn.prox_chain_plain, tol)).abs().max())
              for tol in (0.0, config.mono_tol))
    # the timed call runs at mono_tol; gated-off slots run no pass.  Per
    # gated-on pixel the epilogue adds a compare, the max and a divide
    passes = mono_passes_run(stepped, idx, wt, kt, n_iter, config.mono_tol,
                             running=gate)
    out["prox_chain"] = dict(
        **bound(2 * nbytes(morphs) + nbytes(stepped, idx, thr, gate, wt, kt),
                mono_ops(passes, idx, wt) + 3.0 * float(gate.sum()) * hb * wb),
        mean_passes=float(passes[gate].double().mean()),
        max_abs_err=err, limit=0.0,
        ms=time_ms(lambda: chain(kn.prox_chain, config.mono_tol), 10),
        plain_ms=time_ms(lambda: chain(kn.prox_chain_plain,
                                       config.mono_tol), 3),
        shape=f"{shape} tol={config.mono_tol} and 0")

    fused = lambda f: f(morphs, grads, opt, gate, wt, kt, masks, thr,  # noqa
                        ds, n_iter, 0.0, 1, config.b1, config.b2, config.eps,
                        config.floor)
    (x, o), (rx, ro) = fused(kn.fused_morph_update), fused(
        kn.fused_morph_update_plain)
    errs = [float((a - b).abs().max()) for a, b in zip((x, *o), (rx, *ro))]
    # the step as the plain version takes it, for the pass count at tol 0;
    # per gated-on pixel the prologue is 14 operations, the epilogue 3
    x1 = (morphs - ds[:, None, None, None] * ro.m
          / (torch.sqrt(ro.vhat) + config.eps)) * masks
    fidx = kn.candidate_index(x1, 1)
    passes = mono_passes_run(x1, fidx, wt, kt, n_iter, 0.0, running=gate)
    out["fused_morph_update"] = dict(
        **bound(nbytes(morphs, grads, *opt, masks, gate, thr, ds, wt, kt)
                + 4 * nbytes(morphs),
                mono_ops(passes, fidx, wt)
                + 17.0 * float(gate.sum()) * hb * wb),
        mean_passes=float(passes[gate].double().mean()),
        max_abs_err=max(errs), limit=0.0,
        errors_x_m_v_vhat=errs,
        ms=time_ms(lambda: fused(kn.fused_morph_update), 10),
        plain_ms=time_ms(lambda: fused(kn.fused_morph_update_plain), 3),
        shape=shape)
    for name, res in out.items():
        if res["max_abs_err"] > res["limit"]:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {res['max_abs_err']}")
        log(f"kernel {name}: max_abs_err {res['max_abs_err']:.3g} (limit "
            f"{res['limit']}), kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms [{res['shape']}] on {card}")
    return out


def stream_gather_phase(dev, card, het):
    """K3 and K4 against their plain versions at the stream's shapes
    (chunk 0: its seds, morphologies, origins and slots, pad
    ``config.pad``); K4 on a strided gradient, contiguous and padded."""
    config, _, state, _ = het_setup(dev, het, slice(0, HET["chunk"]))
    C, H, W = config.scene_shape
    P = config.pad
    seds, m = state.seds[0], state.morphs[0]
    origins, on = state.origins[0], state.comp_active[0]
    B, K = on.shape
    shape = f"B={B} K={K} C={C} {H}x{W} box={m.shape[-1]} pad={P}"
    scene = scene_check(seds, m, origins, on, (C, H, W), P)
    grad = grad_check(strided_gradient(B, C, H, W, config.fft_shape, dev),
                      seds, m, origins, P)
    for name, res in (("scene_assembly", scene), ("grad_gather", grad)):
        err = res["g_morph_err"] if name == "grad_gather" \
            else res["max_abs_err"]
        if err != 0.0:
            raise AssertionError(f"{name} at the stream's shapes differs "
                                 f"from its plain version by {err}")
        log(f"kernel {name} at the stream's shapes: max_abs_err "
            f"{res['max_abs_err']:.3g}, kernel {res['ms']:.4f} ms device "
            f"({res['event_ms']:.4f} ms events), plain "
            f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"[{shape}] on {card}")
    log_grad_calls(grad, card)
    return {"scene_assembly": dict(scene, shape=shape),
            "grad_gather": dict(grad, shape=shape)}


def stream_path(dev, card, het, host_init_s):
    """The device stream end to end, from host and from device-resident
    inputs.  Returns (launch counts of one run, summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import stream

    mp = model_psf()

    def run(images, variance, psfs, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = stream.deblend_device_stream(
            images, variance, psfs, het["centers"], mp,
            center_active=het["active"], device=dev, **dict(HET, **kw))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    host_in = (het["images"], het["variance"], het["psfs"])
    _, warm_s = run(*host_in)
    kn.reset_launch_counts()
    res, t = run(*host_in)
    counts = kn.launch_counts()
    host_times = [t] + [run(*host_in)[1] for _ in range(2)]
    dev_in = tuple(torch.from_numpy(x).to(dev) for x in host_in)
    dev_times = [run(*dev_in)[1] for _ in range(3)]
    # per-chunk uploads on a side stream: the same records
    over, over_s = run(*host_in, upload="overlap")
    if [(r["iterations"], r["logL"]) for r in over[0]] != \
            [(r["iterations"], r["logL"]) for r in res[0]]:
        raise AssertionError("upload='overlap' changed the stream's records")

    records = res[0]
    for i, r in enumerate(records):
        if not (np.isfinite(r["logL"]) and np.isfinite(r["init logL"])
                and np.all(np.isfinite(r["flux"]))):
            raise AssertionError(f"stream record {i} is not finite")
    # the fit is not monotone: a blend may stop (|dL| < e_rel |L|) below
    # its initial logL, as in the JAX package (het blend 180: -7149.78 ->
    # -7160.02 in 6 iterations there, on the CPU)
    worse = [i for i, r in enumerate(records)
             if not r["logL"] > r["init logL"]]
    log(f"stream blends whose final logL is not above their initial one: "
        f"{worse}")
    if len(worse) > MAX_WORSE * len(records):
        raise AssertionError(f"logL did not improve for {len(worse)} of "
                             f"{len(records)} stream blends")
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "stream path")

    # the init program alone, per chunk of 128 (device-resident inputs)
    sl = slice(0, HET["chunk"])
    setup_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream.stream_setup(*(x[sl] for x in dev_in), het["centers"][sl], mp,
                            center_active=het["active"][sl],
                            box_size=HET["box_size"], n_slots=HET["n_slots"],
                            device=dev)
        torch.cuda.synchronize()
        setup_times.append(time.perf_counter() - t0)

    # how much of one device-resident stream run the device is busy
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_s = run(*dev_in)
    _, busy_us, _ = device_busy(prof)

    its = np.array([r["iterations"] for r in records])
    summary = dict(
        blends_per_min=N_HET / float(np.median(host_times)) * 60.0,
        wall_s=sorted(host_times), warmup_s=warm_s,
        device_resident_blends_per_min=N_HET / float(np.median(dev_times))
        * 60.0, device_resident_wall_s=sorted(dev_times),
        overlap_upload_wall_s=over_s,
        stream_setup_s_per_chunk=float(np.median(setup_times)),
        host_init_s_per_128=host_init_s,
        median_iterations=float(np.median(its)),
        mean_components=float(np.mean([r["n_components"] for r in records])),
        iterations_sum=int(its.sum()),
        overflow=int(sum(r["overflow"] for r in records)),
        retried=int(sum(bool(r.get("overflow_retried")) for r in records)),
        profiled_wall_s=prof_s,
        profiled_device_busy_share=busy_us / 1e6 / prof_s)
    log(f"device stream of {N_HET} het blends on {dev}: "
        f"{summary['blends_per_min']:.1f} blends/min from numpy (walls "
        f"{[round(x, 3) for x in sorted(host_times)]} s, warm-up "
        f"{warm_s:.2f} s), {summary['device_resident_blends_per_min']:.1f} "
        f"blends/min device-resident; stream_setup "
        f"{summary['stream_setup_s_per_chunk']:.4f} s per chunk of "
        f"{HET['chunk']} vs host init {host_init_s:.2f} s per 128; median "
        f"iterations {summary['median_iterations']}; overflow "
        f"{summary['overflow']} (retried {summary['retried']}); device busy "
        f"{100 * summary['profiled_device_busy_share']:.1f}% of a profiled "
        f"run ({prof_s:.3f} s) on {card}")
    log(f"stream kernel launches (one run): {counts}")
    return counts, summary


def cpu_rerun(dev, het):
    """4 well-conditioned blends initialized and fitted on the card and on
    the CPU (plain versions) at the card's mono_tol: the same discrete
    init decisions, the same final logL."""
    from scarlet_tpu_torch.parallel import batch

    card = het_setup(dev, het, CPU_BLENDS)
    cfg = card[0]
    cpu = het_setup("cpu", het, CPU_BLENDS, mono_tol=cfg.mono_tol)
    pairs = [("origins", card[2].origins[0], cpu[2].origins[0]),
             ("comp_active", card[2].comp_active[0], cpu[2].comp_active[0]),
             ("box_masks", card[1].box_masks[0], cpu[1].box_masks[0])]
    pairs += [(k, card[3][k], cpu[3][k])
              for k in ("slot_source", "split", "psf_fallback")]
    for name, a, b in pairs:
        if not bool((a.cpu() == b).all()):
            raise AssertionError(f"card and CPU init disagree on {name}")
    finals = []
    t0 = time.perf_counter()
    for _, data, state, _ in (card, cpu):
        out, _ = batch.fit_batch_device_converged(
            state, data, cfg, HET["max_iter"], HET["check_every"])
        finals.append(out.last_loss.cpu().numpy())
    rel = np.abs(finals[1] - finals[0]) / np.abs(finals[0])
    log(f"CPU rerun of het blends {CPU_BLENDS} at mono_tol {cfg.mono_tol} "
        f"({time.perf_counter() - t0:.1f} s): init decisions equal; logL "
        f"{finals[1]} vs card {finals[0]}, max rel diff {rel.max():.3g} "
        f"(limit {CPU_RTOL})")
    if not rel.max() <= CPU_RTOL:
        raise AssertionError("CPU and card stream logL disagree")
    return float(rel.max())


def fused_configs(dev, het):
    """Chunk 0 at mono_tol 0, fitted three ways: the default, K5
    (packed_prox_chain) and K6 (packed_morphs off, fuse_morph on).
    Returns ({config: counts}, summary)."""
    import dataclasses
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import batch

    config, data, state, _ = het_setup(dev, het, slice(0, HET["chunk"]),
                                       mono_tol=0.0)
    configs = {
        "default": config,
        "packed_prox_chain": dataclasses.replace(config,
                                                 packed_prox_chain=True),
        "fuse_morph": dataclasses.replace(config, packed_morphs=False,
                                          fuse_morph=True)}
    finals, counts, summary = {}, {}, {}
    for name, cfg in configs.items():
        batch.fit_batch_device_converged(state, data, cfg, HET["max_iter"],
                                         HET["check_every"])
        kn.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, losses = batch.fit_batch_device_converged(
            state, data, cfg, HET["max_iter"], HET["check_every"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = kn.launch_counts()
        finals[name] = out.last_loss.cpu().numpy()
        summary[name] = dict(ms_per_iteration=wall * 1e3 / len(losses),
                             iterations_run=int(len(losses)))
    for name, kernel in (("packed_prox_chain", "prox_chain"),
                         ("fuse_morph", "fused_morph_update")):
        if counts[name][kernel] <= 0:
            raise AssertionError(f"{kernel} was not launched by {name}")
    ref = finals["default"]
    for name in ("packed_prox_chain", "fuse_morph"):
        rel = np.abs(finals[name] - ref) / np.abs(ref)
        med = abs(np.median(finals[name]) - np.median(ref)) / abs(
            np.median(ref))
        # a blend past 1e-4 is reported: generated blends can be chaotic
        # under the fit (PERF.md), where a last-bit change grows
        far = np.flatnonzero(rel > 1e-4).tolist()
        summary[name].update(median_rel=float(med), max_rel=float(rel.max()),
                             blends_beyond_1e_4=far)
        log(f"fused config {name}: median final logL rel diff {med:.3g} "
            f"(limit {FUSED_MEDIAN_RTOL}), max per blend {rel.max():.3g} "
            f"(limit {FUSED_BLEND_RTOL}), blends beyond 1e-4: {far} "
            "(chaotic under the fit: a last-bit change of the morphology "
            "update grows there)")
        if not (med <= FUSED_MEDIAN_RTOL and rel.max() <= FUSED_BLEND_RTOL):
            raise AssertionError(f"{name} disagrees with the default fit")
    for name, res in summary.items():
        log(f"  {name}: {res['ms_per_iteration']:.3f} ms/iteration over "
            f"{res['iterations_run']} iterations; launches {counts[name]}")
    return counts, summary


def attrib_phase(dev, card, k1_fit_ms, k1_morphs, k1_phase_ms, exact):
    """T1: each variant against its plain version at 8 passes on the
    tool's input, then the attribution tool's run, whose launches count;
    then K1's own cost per pass beside ``full``'s, and the passes per K1
    launch it implies beside the ``exact`` counts ({"fit": ...,
    "kernel_phase": ...} mean passes per morphology).  Returns (kernel
    entry, launches, report)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.tools import mono_pass_attrib as tool

    wsel, keepsel, wtab, keep = (torch.from_numpy(a).to(dev)
                                 for a in tool.slot_tables())
    packed = torch.from_numpy(tool.packed_input()).to(dev)
    idx0 = torch.zeros((tool.B, tool.K), dtype=torch.int32, device=dev)
    errs = {}
    for mix in kn.MONO_PASS_MIXES:
        got = kn.mono_pass_variant(packed, wsel, keepsel, mix, 8)
        ref = kn.mono_pass_variant_plain(packed, wsel, keepsel, mix, 8)
        errs[mix] = float((got - ref).abs().max())
        limit = T1_BOUNDS.get(mix, 0.0) * float(ref.abs().max())
        log(f"kernel mono_pass_variant[{mix}]: max_abs_err {errs[mix]:.3g} "
            f"(limit {limit:.3g})")
        if errs[mix] > limit:
            raise AssertionError(f"mono_pass_variant[{mix}] differs from "
                                 f"its plain version by {errs[mix]}")
    full = lambda f: f(packed, wsel, keepsel, "full", 8)  # noqa: E731
    # 8 passes of every slot; the work of the nonzero taps of candidate 0
    res = dict(
        **bound(2 * nbytes(packed) + nbytes(wsel, keepsel),
                mono_ops(torch.full((tool.B, tool.K), 8, device=dev), idx0,
                         wtab)),
        max_abs_err=max(errs.values()),
        limit="0; alu8 1e-6 of max |plain| (fused multiply-add)",
        errors_by_variant=errs,
        ms=time_ms(lambda: full(kn.mono_pass_variant), 10),
        plain_ms=time_ms(lambda: full(kn.mono_pass_variant_plain), 3),
        shape=f"variant full, 8 passes, B={tool.B} x ({tool.S},"
              f"{tool.K * tool.S})")
    log(f"kernel mono_pass_variant: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms [{res['shape']}] on {card}")

    kn.reset_launch_counts()
    report = tool.attribute(dev, reps=9, log=log)
    launches = kn.launch_counts()["mono_pass_variant"]
    print(json.dumps(report), flush=True)
    if report["full_vs_production_max_diff"] != 0.0:
        raise AssertionError("variant full differs from K1: "
                             f"{report['full_vs_production_max_diff']}")
    # K1's own cost per pass, on the same input and card: forced pass
    # counts (no morphology of this input exits before them), a least-
    # squares line as the tool fits its variants
    k1 = lambda n: kn.monotonic_prox_packed(  # noqa: E731
        packed, idx0, wtab, keep, tool.S, n, tol=0.0)
    ran = mono_passes_run(packed.reshape(tool.B, tool.S, tool.K, tool.S)
                          .movedim(-2, -3), idx0, wtab, keep,
                          max(K1_COUNTS), 0.0)
    if not bool((ran == max(K1_COUNTS)).all()):
        raise AssertionError("a morphology of T1's input exits before "
                             f"{max(K1_COUNTS)} passes")
    k1_full_err = float((k1(32) - kn.mono_pass_variant(
        packed, wsel, keepsel, "full", 32)).abs().max())
    if k1_full_err != 0.0:
        raise AssertionError(f"K1 at 32 passes differs from full by "
                             f"{k1_full_err}")
    xs = np.array(K1_COUNTS, float)
    A = np.vstack([xs, np.ones_like(xs)]).T
    ms = [time_ms(lambda: k1(n), 9) for n in K1_COUNTS]
    ys = np.array(ms) * 1e-3
    (tau_b, ovh_b), *_ = np.linalg.lstsq(A, ys, rcond=None)
    r2 = 1 - np.sum((A @ [tau_b, ovh_b] - ys) ** 2) / max(
        np.sum((ys - ys.mean()) ** 2), 1e-30)
    full_slope = report["variants"]["full"]["us_per_pass_per_blend"]
    k1_slope = dict(us_per_pass_per_blend=float(tau_b / tool.B * 1e6),
                    overhead_us_per_blend=float(ovh_b / tool.B * 1e6),
                    r2=float(r2), ms_at_counts=dict(zip(map(str, K1_COUNTS),
                                                        ms)))
    k1_slope["over_full"] = k1_slope["us_per_pass_per_blend"] / full_slope
    report["k1"] = k1_slope
    log(f"K1 (monotonic_prox_packed) {k1_slope['us_per_pass_per_blend']:.5f}"
        f" us/pass/blend, overhead {k1_slope['overhead_us_per_blend']:.4f} "
        f"us/blend, r2 {r2:.6f}, ms at {K1_COUNTS}: "
        f"{[round(m, 4) for m in ms]}; full (the block design's pass) "
        f"{full_slope:.5f} us/pass/blend in the same run: K1 / full = "
        f"{k1_slope['over_full']:.4f}; K1 at 32 passes equals full "
        f"(max diff {k1_full_err}); on {card}")

    # passes per K1 launch: the launch's time per morphology less K1's
    # overhead, over K1's cost per pass and morphology
    tau = k1_slope["us_per_pass_per_blend"] / tool.K
    ovh = k1_slope["overhead_us_per_blend"] / tool.K
    passes = {name: (ms * 1e3 / k1_morphs - ovh) / tau
              for name, ms in (("fit", k1_fit_ms), ("kernel_phase",
                                                    k1_phase_ms))}
    report["k1_passes_per_launch"] = dict(passes, morphologies=k1_morphs,
                                          k1_fit_ms=k1_fit_ms,
                                          k1_kernel_phase_ms=k1_phase_ms,
                                          exact=exact)
    log(f"K1 passes per launch, from K1's {tau:.5f} us per pass and "
        f"{ovh:.4f} us overhead per morphology: {passes['fit']:.1f} in the "
        f"profiled fit ({k1_fit_ms:.4f} ms per launch; exact "
        f"{exact['fit']:.2f}), {passes['kernel_phase']:.1f} in the kernel "
        f"phase ({k1_phase_ms:.4f} ms; exact {exact['kernel_phase']:.2f}), "
        f"{k1_morphs} morphologies per launch, on {card}")
    return res, launches, report


def _catalogs(aux, keys=("centers", "center_active", "detected_peaks")):
    """The stream's catalogs (not the retry entry's), on the host."""
    import torch

    auxs = [a for a in (aux if isinstance(aux, list) else [aux])
            if "retry_indices" not in a]
    return {k: torch.cat([torch.as_tensor(a[k]) for a in auxs]).cpu()
            for k in keys}


def detection_path(dev, card, het, catalog_dev_s):
    """The het stream with device detection (``centers=None``), from
    numpy and device-resident, against the catalog stream's
    device-resident median; the card's catalogs against the CPU's; one
    ``redetect=1`` run.  Returns (launch counts of one run, summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import detection, stream

    mp = model_psf()

    def run(images, variance, psfs, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = stream.deblend_device_stream(images, variance, psfs, None, mp,
                                           device=dev, **dict(HET, **kw))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    host_in = (het["images"], het["variance"], het["psfs"])
    _, warm_s = run(*host_in)
    kn.reset_launch_counts()
    detection.label_components_device.host_syncs = 0
    detection.detect_peaks_device.calls = 0
    res, t = run(*host_in)
    counts = kn.launch_counts()
    syncs = detection.label_components_device.host_syncs
    calls = detection.detect_peaks_device.calls
    host_times = [t] + [run(*host_in)[1] for _ in range(2)]
    dev_in = tuple(torch.from_numpy(x).to(dev) for x in host_in)
    dev_times = [run(*dev_in)[1] for _ in range(3)]

    records, _, _, aux = res
    for i, r in enumerate(records):
        if not (np.isfinite(r["logL"]) and np.isfinite(r["init logL"])
                and np.all(np.isfinite(r["flux"]))):
            raise AssertionError(f"detection record {i} is not finite")
    worse = [i for i, r in enumerate(records)
             if not r["logL"] > r["init logL"]]
    log(f"detection stream blends whose final logL is not above their "
        f"initial one: {worse}")
    if len(worse) > MAX_WORSE * len(records):
        raise AssertionError(f"logL did not improve for {len(worse)} of "
                             f"{len(records)} detection-stream blends")
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "detection path")
    cat = _catalogs(aux)
    if cat["centers"].shape[0] != N_HET:
        raise AssertionError(f"{cat['centers'].shape[0]} catalogs for "
                             f"{N_HET} blends")

    # the same blends' catalogs on the CPU (plain torch), blend by blend;
    # a difference counts against the card unless a 1e-7 perturbation
    # of the images moves the CPU's own catalog there
    n = DET_CPU_BLENDS
    images = torch.from_numpy(het["images"][:n])
    variance = torch.from_numpy(het["variance"][:n])
    cpu = detection.detect_peaks_device(images, variance,
                                        max_peaks=HET["n_slots"])
    card_cat = [cat[k][:n] for k in ("centers", "center_active",
                                     "detected_peaks")]
    differ = [b for b in range(n)
              if not all(torch.equal(a[b], c[b])
                         for a, c in zip(card_cat, cpu))]
    if differ:
        rng = np.random.default_rng(0)
        pert = torch.from_numpy((het["images"][:n].astype(np.float64) * (
            1 + 1e-7 * rng.standard_normal(images.shape))).astype(
                np.float32))
        cpu_p = detection.detect_peaks_device(pert, variance,
                                              max_peaks=HET["n_slots"])
        stable = [b for b in differ
                  if all(torch.equal(a[b], c[b]) for a, c in zip(cpu, cpu_p))]
        log(f"card and CPU catalogs differ on blends {differ}; CPU catalog "
            f"unmoved by a 1e-7 perturbation on {stable}")
        for b in differ:
            log(f"  blend {b}: card {card_cat[0][b][card_cat[1][b]].tolist()}"
                f" ({int(card_cat[2][b])} found), CPU "
                f"{cpu[0][b][cpu[1][b]].tolist()} ({int(cpu[2][b])} found)")
        if stable:
            raise AssertionError(f"card and CPU catalogs differ on the "
                                 f"well-conditioned blends {stable}")
    log(f"card vs CPU catalogs of het blends 0..{n - 1}: "
        f"{n - len(differ)} of {n} equal (rows, order, active, n_found)")

    # where the time goes, per chunk of 128 (device-resident, synchronized):
    # detection alone, and stream_setup with and without it; the device's
    # busy share of a profiled run; the fitted components and iterations
    sl = slice(0, HET["chunk"])

    def timed(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    chunk_in = [x[sl] for x in dev_in]
    detect_s = timed(lambda: detection.detect_peaks_device(
        chunk_in[0], chunk_in[1], max_peaks=HET["n_slots"]))
    setup_kw = dict(box_size=HET["box_size"], n_slots=HET["n_slots"],
                    device=dev)
    setup_det_s = timed(lambda: stream.stream_setup(*chunk_in, None, mp,
                                                    **setup_kw))
    setup_cat_s = timed(lambda: stream.stream_setup(
        *chunk_in, het["centers"][sl], mp, center_active=het["active"][sl],
        **setup_kw))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_s = run(*dev_in)
    _, busy_us, _ = device_busy(prof)

    # one redetect pass on the first blends, from numpy
    m = REDETECT_BLENDS
    t0 = time.perf_counter()
    rres = stream.deblend_device_stream(
        *(x[:m] for x in host_in), None, mp, device=dev, redetect=1, **HET)
    torch.cuda.synchronize()
    redetect_s = time.perf_counter() - t0
    rcat = _catalogs(rres[3], ("centers", "center_active"))
    if not all(np.isfinite(r["logL"]) for r in rres[0]):
        raise AssertionError("a redetect record is not finite")
    rows0 = int(cat["center_active"][:m].sum())
    rows1 = int(rcat["center_active"].sum())
    if rows1 < rows0:
        raise AssertionError(f"redetect shrank the catalog: {rows0} -> "
                             f"{rows1} rows")

    its = np.array([r["iterations"] for r in records])
    det_dev = float(np.median(dev_times))
    summary = dict(
        detection_blends_per_min=N_HET / float(np.median(host_times)) * 60.0,
        wall_s=sorted(host_times), warmup_s=warm_s,
        device_resident_blends_per_min=N_HET / det_dev * 60.0,
        device_resident_wall_s=sorted(dev_times),
        catalog_device_resident_s=catalog_dev_s,
        detection_overhead_pct=100.0 * (det_dev - catalog_dev_s)
        / catalog_dev_s,
        median_iterations=float(np.median(its)),
        mean_detected_peaks=float(cat["detected_peaks"].float().mean()),
        mean_catalog_rows=float(cat["center_active"].sum(1).float().mean()),
        detect_calls=calls, label_host_syncs=syncs,
        host_syncs_per_detect_call=syncs / max(calls, 1),
        overflow=int(sum(r["overflow"] for r in records)),
        retried=int(sum(bool(r.get("overflow_retried")) for r in records)),
        cpu_catalog_blends=n, cpu_catalog_equal=n - len(differ),
        cpu_catalog_differ=differ,
        redetect_blends=m, redetect_wall_s=redetect_s,
        redetect_rows_before=rows0, redetect_rows_after=rows1,
        detect_s_per_chunk=detect_s, setup_detect_s_per_chunk=setup_det_s,
        setup_catalog_s_per_chunk=setup_cat_s,
        mean_components=float(np.mean([r["n_components"] for r in records])),
        iterations_sum=int(its.sum()), profiled_wall_s=prof_s,
        profiled_device_busy_share=busy_us / 1e6 / prof_s)
    log(f"detection stream of {N_HET} het blends on {dev}: "
        f"{summary['detection_blends_per_min']:.1f} blends/min from numpy "
        f"(walls {[round(x, 3) for x in sorted(host_times)]} s, warm-up "
        f"{warm_s:.2f} s), {summary['device_resident_blends_per_min']:.1f} "
        f"device-resident; overhead over the catalog stream "
        f"{summary['detection_overhead_pct']:.2f}% (device-resident medians "
        f"{det_dev:.4f} vs {catalog_dev_s:.4f} s); median iterations "
        f"{summary['median_iterations']}; {summary['mean_detected_peaks']:.2f}"
        f" peaks detected per blend ({summary['mean_catalog_rows']:.2f} "
        f"catalog rows); {syncs} label host syncs in {calls} detection "
        f"calls; redetect=1 on {m} blends {redetect_s:.3f} s, catalog "
        f"{rows0} -> {rows1} rows; per chunk of {HET['chunk']}: detection "
        f"{detect_s:.4f} s, stream_setup {setup_det_s:.4f} s with it and "
        f"{setup_cat_s:.4f} s with the catalog; "
        f"{summary['mean_components']:.2f} components per blend, "
        f"{summary['iterations_sum']} iterations in all; device busy "
        f"{100 * summary['profiled_device_busy_share']:.1f}% of a profiled "
        f"run ({prof_s:.3f} s), on {card}")
    log(f"detection kernel launches (one run): {counts}")
    return counts, summary


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
        if any(k in line for k in ("registers", "Compiling entry", "spill")):
            log("  " + line.strip())
    build.load()
    # the projection kernels as the path launches them (box 59)
    from scarlet_tpu_torch.ops import kernels as kn
    for name, info in kn.mono_kernel_info(59, 59).items():
        log(f"{name} at box 59: T={info['T']} P={info['P']}, "
            f"{info['threads']} threads, {info['registers']} registers, "
            f"{info['spill_bytes']} B local (spill) per thread, "
            f"{info['smem_bytes']} B shared, {info['blocks_per_sm']} "
            f"blocks resident per SM")

    single, setup, init_s = setup_blends(dev)
    config = setup[0]
    log_gather_info(*setup[2].comp_active[0].shape, *config.scene_shape,
                    *config.box_shapes[0], config.pad, card)
    kres = kernel_phases(dev, card, setup)
    host_counts, summary = main_path(dev, card, single, setup, init_s)
    log(f"summary: {json.dumps(summary)}")
    fit_profile = profile_fit(setup)
    k1_fit_ms = fit_profile["K1"]["ms_per_launch"]
    for label, name in (("K3", "scene_assembly"), ("K4", "grad_gather")):
        kres[name]["fit_profile"] = fit_profile[label]
    kres["grad_gather"]["fit_profile_pad"] = fit_profile["pad"]
    k1_morphs = int(setup[2].comp_active[0].numel())
    k1_fit = fit_k1_work(setup)
    log(f"K1 in the profiled fit: {k1_fit_ms:.4f} ms per launch, "
        f"{k1_fit['mean_passes']:.2f} passes per morphology (exact, over "
        f"{k1_fit['launches']} launches), bound {k1_fit['bound_ms']:.4f} ms "
        f"by {k1_fit['bound_by']} ({k1_fit['bound_bytes']} B, "
        f"{k1_fit['bound_ops']} operations): "
        f"{100.0 * k1_fit['bound_ms'] / k1_fit_ms:.1f}% of the bound's "
        f"speed, on {card}")
    del single, setup

    het = make_het()
    kres.update(stream_kernel_phases(dev, card, het))
    for name, res in stream_gather_phase(dev, card, het).items():
        kres[name]["stream_shapes"] = res
    stream_counts, stream_summary = stream_path(
        dev, card, het, init_s * 128 / N_BLENDS)
    log(f"stream summary: {json.dumps(stream_summary)}")
    cpu_rel = cpu_rerun(dev, het)
    fused_counts, fused_summary = fused_configs(dev, het)
    log(f"fused summary: {json.dumps(fused_summary)}")
    kres["mono_pass_variant"], t1_launches, _ = attrib_phase(
        dev, card, k1_fit_ms, k1_morphs, kres["monotonic_prox"]["ms"],
        dict(fit=k1_fit["mean_passes"],
             kernel_phase=kres["monotonic_prox"]["mean_passes"]))
    _, det_summary = detection_path(
        dev, card, het, float(np.median(
            stream_summary["device_resident_wall_s"])))
    log(f"detection summary: {json.dumps(det_summary)}")

    # each kernel's launches from the run of the path that drives it:
    # K1, K3 and K4 from one device-stream run, K5 and K6 from the fit of
    # their configuration
    launches = dict(stream_counts)
    launches["prox_chain"] = fused_counts["packed_prox_chain"]["prox_chain"]
    launches["fused_morph_update"] = \
        fused_counts["fuse_morph"]["fused_morph_update"]
    launches["mono_pass_variant"] = t1_launches
    path = dict(prox_chain="fit, packed_prox_chain",
                fused_morph_update="fit, fuse_morph",
                mono_pass_variant="tools.mono_pass_attrib")
    # no one PyTorch call computes any of them (PERF.md): library_ms null
    main_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name], launches=int(launches[name]),
             **{k: res[k] for k in main_keys}, library_ms=None,
             path=path.get(name, "device stream"),
             launches_host_path=int(host_counts[name]),
             **{k: v for k, v in res.items() if k not in main_keys})
        for name, res in kres.items()]
    log(f"CPU rerun max rel logL diff {cpu_rel:.3g}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
