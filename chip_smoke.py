#!/usr/bin/env python3
"""Smoke test of scarlet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

1. Builds the host C library of ``scarlet_tpu_torch/native`` (the host
   compiler, its seconds and flags), then the CUDA kernels of
   ``scarlet_tpu_torch/ops/csrc`` with nvcc
   (one compiler process per source, all at once), prints each kernel's
   registers and spills, the projection kernels' resident blocks per SM
   at box 59, and K3's and K4's registers, spill, shared bytes, blocks
   per SM and grid at the host path's shapes (K4 also at the gradient
   padded by the scene pad, its tiled route).
2. Holds K1-K4 against their plain PyTorch versions on the card at the
   host path's shapes (128 blends x 16 components, box 59, 5 bands,
   58 x 48 scenes, with negative origins and an argmax tie), and times
   both with CUDA events.  K4 runs as the fit calls it (the unpadded
   gradient, a strided crop, pad 0: the staged route), contiguous, and
   padded (the tiled route), each held bit for bit in g_morph, to
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
   ``mono_pass_variant`` (``ops/csrc/attrib.cu``, K1's pass engine) against
   its plain version at 8 passes on the tool's input (128 x (59, 590)),
   then runs ``scarlet_tpu_torch.tools.mono_pass_attrib`` (its path),
   checks that ``full`` equals K1 bit for bit and prints its JSON line;
   then fits K1's own cost per pass on the same input (``K1_COUNTS``)
   beside ``full``'s, the two timed in turns (K1 / full must lie in
   ``K1_OVER_FULL``), logs the
   parts of K1's pass and estimates the passes each K1 launch of the
   profiled fit runs, beside the exact count.
6. Device detection: the het stream with ``centers=None`` (warm-up, then
   three runs from numpy and three device-resident), its overhead over
   the catalog stream, the host syncs per detection call, the card's
   catalogs against the CPU's for 32 blends, and one ``redetect=1`` run
   on the first 128 blends.
7. The wavelet init recipe: the het stream with ``recipe="wavelets"``
   (warm-up, three runs from numpy, three device-resident) beside the
   main recipe's device-resident median, ``stream_setup`` per chunk of
   128 for both recipes, the monotonic-mask closure's passes and host
   reads per call (its counters) and the device ms of its profiler
   range, the launches of K1, K3 and K4, 4 blends' init
   decisions and final logL (50 iterations at e_rel 0) against the CPU;
   chunk 0 with ``use_mask=True`` (K1 launched in the fit only, the
   CPU's decisions on 4 blends); one ``centers=None`` wavelet run on the
   first 128 blends.
8. The fit options.  K1 with one exit tolerance per blend (the TPU
   kernel's ``tol_arr`` mode) at the stream's shapes, tolerances 0, 1e-3
   and 1e6 by turns, bit for bit against its plain version (and K2); a
   tensor of the static tolerance gives the float launch's bits; its time
   with the tensor beside the float's.  The matmul-DFT convolution
   against cuFFT: both routes (complex64, split re/im) and TF32 against a
   float64 reference; 15-iteration loss trajectories, device ms and
   launches per iteration (``torch.profiler``) and blends/min of both
   modes in turns (3 runs each) on the host path and on het chunk 0.  The
   het stream with ``box_grow=0.1`` and with ``mono_tol_early=1e-2,
   mono_tol_switch=10`` (blends/min, median iterations, grown slots with
   their step scales, no blend frozen before the switch, K1's per-blend
   launches counted); the oversized source of tests/test_box_growth.py on
   the card and the CPU; FISTA on the host path (the host init's seeds
   through ``init_fista_component``, ``pack_blends``,
   ``fit_batch_device_converged``, 4 blends refitted on the CPU).
9. The multi-resolution fit (``parallel.MultiResFitter``) on the
   synthetic HR + LR pair at tools/multires_bench.py's widths (HR 64 x 64
   at 0.1", LR 24 x 24 at 0.3"; B = 64 flux-scaled blends, box 31, 3
   slots): aligned (100 iterations) and rotated by 28 degrees (120), each
   one warm-up and three timed fits (blends/min, ms per iteration, median
   iterations, peak memory, K1/K3/K4 launches of one fit), a profile of
   20 iterations (device busy share, launches and device ms per iteration
   by K1, K3, K4, cuFFT and matmul), every blend's HR and LR SDR, and
   blend 0's renders against a float64 CPU render (and with TF32
   allowed); 4 aligned blends over 30 iterations on the card and the
   CPU; K1, K3 and K4 against their plain versions at the fit's shapes;
   ``deblend_multires(centers=None)`` on 64 aligned blends (4 slots, 60
   iterations), with the detection's own time.
10. The object tree, scarlet's quickstart (``examples/quickstart.py``) on
   the port: K1 against its plain version at the tree's shapes ((1, 1,
   S, S), S = 21, 31, 41 and, on its wide kernel, 81, 128 and 150;
   "angle" and "flat" tables, min_gradient 0 and 0.1, the
   fit_center_radius=1 candidate table), bit for bit; 16
   generated blends of (5, 58, 48) with 7 sources (``default_rng(11)``)
   through ``models.Frame``, ``Observation.match``,
   ``initialization.init_all_sources`` and ``Blend.fit(100, e_rel=1e-4)``
   in turn after a warm-up (blends/min, init s, iterations, ms per
   iteration, chi2/dof, logL, K1's launches); a profile of 20 iterations
   (device busy share, launches and K1 per iteration); a (5, 128, 128)
   scene with 24 sources (100 iterations, ms per iteration, peak memory;
   busy share over 5 more); two blends on the card and the CPU (init
   decisions, the first loss, 20 iterations' losses from the quickstart's
   start against the CPU's own spread on perturbed images, and from the
   init without the spectrum solve), the CPU's runs in worker processes;
   a large galaxy whose box grows past 73 pixels (K1's wide kernel) on
   the card and the CPU (boxes, losses).
11. The starlet recipes, the reference's ``wavelet_model`` tutorial as
   the JAX package's examples run it: (a) ``examples/starlet_source.py``
   on the object tree's 16 blends after a warm-up (``detect.get_peaks``
   against the catalog, the first source a ``StarletSource``, the others
   ``SingleExtendedSource``s, ``Blend.fit(80, e_rel=1e-4)``: blends/min,
   init s, iterations, ms per iteration, chi2/dof, K1's launches), a
   profile of 20 iterations (device busy share, launches and K1 per
   iteration) and the starlet reconstruction's own device ms and
   launches, forward and backward, at the fit's coefficient shape; (b)
   ``examples/lsbg_wavelet_model.py`` on the large scene plus a diffuse
   exponential disk standing in for the tutorial's lsbg.pkl (compact
   sources from ``init_all_sources(max_components=1, min_snr=50, ...,
   set_spectra=False)``, a full-frame ``StarletSource(frame)`` after
   ``np.random.seed(0)``, ``Blend.fit(200, e_rel=1e-6)``: ms per
   iteration, busy share, peak memory, the diffuse source's rendered flux
   against the disk's, which must be positive); K1 against its plain
   version, bit for bit, on the first input of every shape, table and
   depth (a) and (b) launched; two blends of (a) and the field of (b) on
   the card and the CPU (worker processes): peaks, kinds and boxes equal,
   starlet seed coefficients within 1e-6, 20 iterations' losses within
   1e-4, the starlet boxes after the fit equal.
12. The sharded fit (``parallel.fit_batch_sharded`` over
   ``torch.distributed``): (a) one NCCL rank (a ``FileStore`` group of
   world size 1) on the host path's batch for 100 iterations, bit for bit
   against ``fit_batch`` in every leaf of the state and in the losses,
   K1, K3 and K4 launched, ms per iteration of both in turns; (b) two
   ranks spawned on the one card over gloo, on 128 generated (4, 58, 48)
   blends (``default_rng(7)``, the first four filters, ``stream_setup``'s
   layout, the unpacked branch and the exact projection), mesh (1, 2)
   with the channels split and mesh (2, 1), 20 iterations each, held to
   the JAX test's limits against the unsharded card fit (losses rtol
   1e-5; SEDs and morphologies rtol 1e-4, atol 1e-6), with each rank's
   K1, K3 and K4 launches, ms per iteration and all-reduces per
   iteration; K3 and K4 at C = 4 and 2 and K1 at half the batch against
   their plain versions, bit for bit (g_sed to GRAD_SED_RTOL).  One card
   measures no collective's speed: gloo carries each band sum through
   the host.
13. The production host paths, each with the kernel counts zeroed just
   before it: (a) ``parallel.BlendPipeline`` with min(8, cores) CPU
   workers (spawned with the card hidden, one torch thread each) on the
   host path's 128 blends as blobs (a warm-up, then four runs of
   ``max_iter`` 100: ``last_timings``, blends/min beside the in-process
   host init of step 3; the same run with torch's default threads in
   every worker), its records held to the same fit of step 3's packed
   batch in process (iterations equal, logL to 1e-6), every worker
   reporting no CUDA device; (b) ``python -m scarlet_tpu_torch deblend``
   as a subprocess on the card (its launch counts printed by that
   process) on 64 generated npz files (8 without a catalog, 8 without
   variance): blends/min, records finite, logL improving for all but
   2%, median centroid error under 2 px; ``--detect device`` against
   ``--detect host`` (sorted centroids within 0.1 px); 8 files with
   ``--cpu`` against the card (iterations equal and logL within 1e-4,
   or, where the card's own runs on 8 copies of the images times
   (1 + 1e-7 N(0, 1)) move them, within 3x that move); (c) the
   regression harness on a generated set 4 (50 blends): "stream" and
   "lite" on all, "main" on 4 (wall, median logL and iterations), stream
   against lite logL within 2% on the JAX test's 4 blends (the rest
   logged), detection on the card with the host's completeness; K1, K3
   and K4 against their plain versions, bit for bit (K4's g_sed to
   GRAD_SED_RTOL), at the pipeline's and the CLI's fit shapes.
14. The ten tutorial examples (``scarlet_tpu_torch.examples``, the JAX
   package's ``examples/*.py``) in its order, each ``run()`` on the card
   on the generated stand-in of its data file at the file's size
   (``testing.example_data``; the multiresolution example makes its own
   data) at the JAX script's full depths (``EX_FAST``), with the kernel
   counts zeroed just before it, figures into a temporary directory
   where matplotlib is installed (where it is not, as on the card
   machine, every other step runs and no PNG is written).
   Per example: wall seconds by step (init, fit, display; host clock
   after ``torch.cuda.synchronize()``), iterations, logL first and last,
   the figures' RGB panels, the PNGs and their sizes, K1, K3 and K4
   launches.  Holds: every figure's RGB panels computed (the display's
   numerics run with or without matplotlib) under the PNG names of the
   JAX package's script, every PNG non-empty (none without matplotlib),
   every logL finite and improving, the quickstart's refit improving its
   logL on its own start (its ``run()`` keeps the JAX script's
   ``loss[-1] < loss[0] / 20``, which holds whatever the refit does
   where logL > 0, and at full depth holds the refit at or above the
   first fit's logL), K1 launched by every example and
   K3 and K4 by the five that fit through the lite engine or the
   multi-resolution fitter, and K1, K3 and K4 against their plain
   versions on the first input of every shape new to the phase (K1 and
   K3 bit for bit, K4's g_morph bit for bit and g_sed to GRAD_SED_RTOL).
   The display's panels (``display.scene_panels``, ``source_panels``,
   ``observation_panels``: what ``show_scene``, ``show_sources`` and
   ``show_observation`` draw, in numpy) of the quickstart's card-fitted
   sources and of the same sources moved to the CPU: every RGB array
   equal.
   Then starlet_source's recipe with ``monotonic=True``: the host mask
   projection's calls and seconds against the fit's wall (ROADMAP Queue 1
   item 6).
15. The host C library (``scarlet_tpu_torch.native``, the host paths'
   seeds and mask fills): one host init of the 128 host-path blends
   recording every ``init_monotonic_morph`` seed, then NATIVE_RUNS timed
   runs (s per 128); one monotonic starlet fit of step 14 recording every
   plane of the mask projection, then NATIVE_RUNS timed fits (the mask
   share); in worker processes, the C sweep on every recorded seed
   against its numpy twin and every seed against the plain Jacobi route
   (the projection at ``monotonic_depth`` passes), and the C fill with
   orphans on every recorded plane against the twins', all bit for bit;
   ``apply_filter`` with each blend's PSF on its detection image and
   ``label_components`` of that image at NATIVE_LABEL_SIGMAS, bit for bit
   against their twins; the pipeline's ``init_s`` and blends/min of step
   13's steady runs (all but the first) and the starlet phase's mask
   counts: medians and spreads.
16. The JAX package's last stream and engine options: (a)
   ``upload_dtype=torch.bfloat16`` on the het stream, bulk and overlap in
   turns with float32 (UPLOAD_RUNS runs each; K1, K3 and K4 counted from
   zero over one bf16 bulk run): the quantized stacks on the card bit
   for bit the host rounding, bytes copied, the host's quantization into
   pinned memory (s) and the copies (ms, CUDA events) beside float32's,
   blends/min, logL and flux drift against the float32 records, the
   blends whose component counts or init decisions (boxes, origins,
   splits, PSF fallbacks) moved, bulk and overlap records bit for bit;
   (b) ``upload="auto"``: the probe's MB/s, the mode the stream chose
   (its log line) and records bit for bit with bulk; (c) the bf16 tiers
   of the DFT convolution at the host path's shapes: device ms of
   "float32", "high" and "default" beside cuFFT, the error of each
   against float64 inside the tier's band (TIER_ERR: no fall-back to
   float32 or to a bf16 result), the bf16 GEMM kernels each tier call
   launches, its four products against their plain version on the CPU
   (BF16_PRODUCT_RTOL); 15-iteration loss trajectories of each tier
   against "float32" on het blends CPU_BLENDS; converged fits of het
   chunk 0 with ``conv_mode="dft"`` at each tier in turns (blends/min,
   logL drift; K1, K3 and K4 counted over one fit at "high").
17. Any band count and any box: (a) K3 and K4 against their plain
   versions at C = 8, 9, 10, 12, 16 and 40 (BAND_CHECKS), on the lite
   fit's shapes (128 blends x 16 components, box 59, 58 x 48: K4's tiled
   route) and on a 24 x 24 scene (box 21: staged at 8 bands), each on the
   unpadded gradient and padded by the box: K3 and g_morph bit for bit,
   g_sed to GRAD_SED_RTOL, two launches bitwise; K3 alone bit for bit at
   C = 1-10, 12, 16 and 40 (SCENE_CHECK_BANDS) on the lite fit's shapes
   and at 5 and 12 on TILED_SHAPES' boxes, on contiguous and strided
   morphologies, by the shape's walk and, up to 8 bands, by the staged
   walk forced; (b) the device stream
   on 64 generated (10, 58, 48) blends at the het cell's settings
   (counted from zero; records finite and 10 bands wide, logL improving),
   4 of them on the card and the CPU (init decisions equal, logL within
   CPU_RTOL), and ``MultiResFitter`` on the pair with 6 HR and 4 LR
   bands (10 model channels, 4 blends, 10 iterations) against the CPU
   at rtol 1e-4; (c) the wide engine (boxes past 73 pixels, a morphology
   over a cluster of R CTAs): K1, K5 and K6 (``mono_kernel_wide``,
   ``chain_kernel_wide``, ``fused_kernel_wide``) bit for bit with their
   plain versions at boxes 81 and 101 (4 x 8 morphologies) and at the
   object tree's 81, 128 and 150 (one morphology), one launch per call
   and none of K1 from K5 or K6, each timed (CUDA events) beside its
   plain version and its bound, with R; 32 het blends packed at box 81
   fitted 20 iterations by default, with ``packed_prox_chain`` (logL bit
   for bit with the default) and with ``fuse_morph`` (within the fused
   configurations' tolerances), each counted from zero; (d) K3 and K4 at
   C = 3, 5, 8, 10, 16 and 40 on the lite fit's shapes: device ms (CUDA
   events over replays of a CUDA graph of 20 calls) and CUDA events around
   one call (medians of 10) beside the bytes bound, K3's walk, band
   groups, registers and spill; (e) K4 at box 81 (32
   x 16 on 80 x 80, 5 bands) and at boxes 171, 201 and 256 on scenes of
   their size (TILED_SHAPES): strided, contiguous and padded gradients
   bit for bit in g_morph, g_sed to GRAD_SED_RTOL, two launches bitwise,
   route, device ms, plain ms and bound; (f) a lite fit at box 181 on a
   180 x 180 scene (the large galaxy and a second source, 10 iterations
   through the engine, counted from zero): K4 once an iteration on its
   tiled route, losses finite and improving, and within 1e-4 of the
   CPU's with float64 convolutions on both and with the card's
   convolutions run on the CPU; cuFFT's float32 fit's gap is logged
   beside the CPU's fits one float32 rounding of the model's scale apart
   (the fit turns on that rounding: ROADMAP.md Queue 3, F4).
18. Prints one JSON line with the kernels, the card's name and power
   limit, then, last, the device line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device, or outside
the repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import importlib
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
# input (no morphology there exits before 48 passes), in turns with
# T1's full over K1_ROUNDS rounds
K1_COUNTS = (8, 16, 24, 32)
K1_ROUNDS = 31
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
# K1 / full, K1's own cost per pass over T1's ``full`` (K1's pass on the
# same engine, forced) in one run: outside this range the attribution
# does not split the pass K1 runs
K1_OVER_FULL = (0.8, 1.25)
# het blends whose catalogs the card and the CPU detect
DET_CPU_BLENDS = 32
REDETECT_BLENDS = 128
# iterations of the wavelet stream's card-vs-CPU rerun (e_rel 0)
WAVELET_CPU_ITERS = 50

# the multi-resolution phase: tools/multires_bench.py's configuration (HR
# 64 x 64 at 0.1", LR 24 x 24 at 0.3", B = 64, box 31, 3 slots) and its
# 28-degree rotated form (tests/test_multires_batch.py:177-196)
MR_B, MR_BOX, MR_SLOTS, MR_RUNS = 64, 31, 3, 3
MR_ITERS, MR_ROT_ITERS = 100, 120
MR_ROTATION = np.deg2rad(28)
MR_CPU_BLENDS, MR_CPU_ITERS = 4, 30
MR_DETECT_SLOTS, MR_DETECT_ITERS = 4, 60
MR_F64_RTOL = 1e-5   # a float32 render (TF32 off) against float64
# the aligned batch's blend that the reference's own stop rule freezes
# below 10 dB HR, and its iteration (tests/test_torch_multires.py::
# test_stop_rule_freezes_like_jax)
MR_SDR_FROZEN = {40: 25}

# the object tree: scarlet's quickstart recipe (examples/quickstart.py:
# 22-36) on generated blends of hsc_cosmos_35's size (5 bands, 58 x 48, 7
# sources), OT_BLENDS in turn after a warm-up; a large scene; the card
# against the CPU on two of them (losses over OT_CPU_ITERS iterations)
OT_BLENDS, OT_SEED, OT_SHAPE, OT_SOURCES = 16, 11, (5, 58, 48), 7
OT_MAX_ITER, OT_E_REL, OT_PROFILE_ITERS = 100, 1e-4, 20
OT_LARGE_SHAPE, OT_LARGE_SOURCES, OT_LARGE_ITERS = (5, 128, 128), 24, 100
# the large scene's busy share from a short window: the profiler's own
# cost grows with its ~6,000 launches per iteration
OT_LARGE_PROFILE_ITERS = 5
OT_BOXES = (21, 31, 41)
# boxes beyond the register-tap kernel (mono_kernel_wide): a grown fit box
# (81), the large scene's whole-frame seed projections (128), and planes
# that do not fit in shared memory (150: the workspace route)
OT_WIDE_BOXES = (81, 128, 150)
OT_CPU_BLENDS, OT_CPU_ITERS = (1, 2), 20
OT_CPU_RTOL = 1e-4      # losses, card vs CPU
OT_START_RTOL = 1e-5    # the first loss: the init's spectra (renders)
# the CPU's own spread from the quickstart's start: the largest difference
# between any two of its runs on the images and on the images times
# (1 + OT_PERTURB * N(0, 1)), one run per seed; the card may part from the
# CPU by OT_WITNESS_FACTOR times that spread where it exceeds OT_CPU_RTOL
OT_PERTURB, OT_WITNESS_SEEDS, OT_WITNESS_FACTOR = 1e-7, (0, 1, 2, 3), 3.0

# the starlet recipes (the reference's wavelet_model tutorial): (a)
# examples/starlet_source.py on the object tree's blends, (b)
# examples/lsbg_wavelet_model.py on the large scene with a diffuse disk
SL_MAX_ITER, SL_E_REL, SL_THRESH, SL_PROFILE_ITERS = 80, 1e-4, 5e-3, 20
SL_MATCH_PX = 2.0       # a catalog entry is detected: a peak this close
LSBG_ITERS, LSBG_E_REL = 200, 1e-6
LSBG_RADIUS, LSBG_PEAK = 30.0, 0.5   # the disk: px, noise sigmas at peak
SL_CPU_BLENDS, SL_CPU_ITERS = (1, 2), 20
SL_CPU_RTOL = 1e-4      # losses, card vs CPU
SL_SEED_RTOL = 1e-6     # starlet seed coefficients, card vs CPU

REPLACES = {
    "monotonic_prox": "scarlet_tpu/ops/pallas_kernels.py:204",
    "prox_chain": "scarlet_tpu/ops/pallas_kernels.py:399",
    "fused_morph_update": "scarlet_tpu/ops/pallas_kernels.py:612",
    "scene_assembly": "scarlet_tpu/ops/pallas_kernels.py:694",
    "grad_gather": "scarlet_tpu/ops/pallas_kernels.py:772",
    "mono_pass_variant": "tools/mono_pass_attrib.py:193",
    "monotonic_prox_tol_tensor": "scarlet_tpu/ops/pallas_kernels.py:40-135, "
                                 "182-202, 231-251",
}
SOURCES = {
    "monotonic_prox": "scarlet_tpu_torch/ops/csrc/mono.cu",
    "prox_chain": "scarlet_tpu_torch/ops/csrc/mono.cu",
    "fused_morph_update": "scarlet_tpu_torch/ops/csrc/mono.cu",
    "scene_assembly": "scarlet_tpu_torch/ops/csrc/scene.cu",
    "grad_gather": "scarlet_tpu_torch/ops/csrc/grad.cu",
    "mono_pass_variant": "scarlet_tpu_torch/ops/csrc/attrib.cu",
    "monotonic_prox_tol_tensor": "scarlet_tpu_torch/ops/csrc/mono.cu",
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


def taps_bytes(idx, wt, kt):
    """Bytes of the tables that the projection kernels read: for each
    distinct candidate that ``idx`` selects, its compact taps
    (``kernels.mono_taps``: T weights and one code per pixel, and its
    center index).  The dense tables ``wt``/``kt`` are never read."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn

    taps = kn._device_taps(wt, kt)
    per = nbytes(taps.weights[0], taps.codes[0], taps.centers[:1])
    return int(torch.unique(idx).numel()) * per


def mono_passes_run(morphs, idx, wt, kt, n_iter, tol, running=None,
                    scale=1.0):
    """The passes each morphology of (..., K, hb, wb) runs under the
    projection's exit rule (blocks of 4, the last two compared), from
    the plain passes: an integer tensor (..., K).  ``tol``: a float or one
    per blend (..., ).  ``running`` (..., K) bool: morphologies that run
    at all (the others run 0)."""
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
        changed = kn._block_changed(new, x, tol)
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


# attempts of a profiled window: the profiler has come back without any
# kernel event (CUDA activity alone) now and then
PROFILE_TRIES = 5


def kernel_events(fn, reps, key=None):
    """Device kernel events of ``reps`` calls of ``fn`` under
    ``torch.profiler`` (host and device activity), after a warm-up call;
    with ``key``, those whose name holds it.  Raises if the profiler
    records none in PROFILE_TRIES windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation
                and (key is None or key in e.name)]
        if kern:
            return kern
        time.sleep(1.0)
    raise AssertionError(f"the profiler recorded no {key or 'kernel'} "
                         f"launch in {PROFILE_TRIES} windows")


def device_ms_all(fn, reps=20):
    """Device ms per call of all the kernels ``fn`` launches, summed, over
    ``reps`` calls (``torch.profiler``), after a warm-up call; and the
    kernels per call.  For calls of several short kernels, whose CUDA
    event times the host's launch gaps swing."""
    kern = kernel_events(fn, reps)
    return (sum(e.time_range.elapsed_us() for e in kern) / reps / 1e3,
            len(kern) / reps)


def device_ms(fn, key, reps=20):
    """Median device time in ms of the kernels whose name holds ``key``
    over ``reps`` runs of ``fn`` (``torch.profiler``), after a warm-up run:
    the kernel's own time, without the host's launch gaps that CUDA events
    around a call of a few tens of microseconds also count."""
    kern = kernel_events(fn, reps, key)
    return float(np.median([e.time_range.elapsed_us() for e in kern])) / 1e3


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


def scene_check(seds, m, origins, on, scene_shape, P, timer=None):
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
        ms=(timer or device_ms)(lambda: kn.scene_assembly(
            seds, m, origins, on, scene_shape, P), "scene_kernel"),
        event_ms=time_ms(lambda: kn.scene_assembly(seds, m, origins, on,
                                                   scene_shape, P), 20),
        plain_ms=time_ms(lambda: kn.scene_assembly_plain(
            seds, m, origins, on, scene_shape, P), 5))


def grad_check(grad, seds, m, origins, P, timer=None):
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
            grad_route=kn.grad_geometry(B, K, C, *g.shape[-2:], hb,
                                        wb).route, pad=p,
            g_morph_err=float((gm - rm).abs().max()),
            g_sed_abs_err=float((gs - rs).abs().max()),
            g_sed_rel_err=sed_err, repeat_bitwise=same,
            ms=(timer or device_ms)(
                lambda: kn.grad_gather(g, seds, m, origins, p),
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
        **bound(2 * nbytes(morphs) + nbytes(idx) + taps_bytes(idx, wt, kt),
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
    # 0), then contiguous, then padded by P (the tiled route) ---
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
    if routes != {"staged", "tiled"}:
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
                if name == "grad_gather" else (
                    f", {i['route']} walk, XV={i['XV']}, {i['NG']} band "
                    f"group(s) of {i['CG']} at most, {i['GT']} at once, "
                    f"{i['walks']} walk(s)")
            log(f"{name} at B={B} K={K} C={C} {hw[0]}x{hw[1]} (pad {pad})"
                f"{route}: grid {tuple(i['grid'])}, {i['threads']} threads,"
                f" {i['registers']} registers, {i['spill_bytes']} B local "
                f"(spill) per thread, {i['smem_bytes']} B shared, "
                f"{i['blocks_per_sm']} blocks resident per SM on {card}")


def build_seeds(lite, d):
    """The host initialization of one generated blend: (sources with raw
    seeds, observation)."""
    weights = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = lite.LiteObservation(d["images"], d["variance"], weights,
                               d["psfs"], model_psf=model_psf, device="cpu")
    centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
               for r in d["catalog"]]
    return lite.init_all_sources_main(obs, centers, min_snr=50), obs


def parameterized(lite, seeds, param="init_adaprox_component"):
    sources, obs = seeds
    return lite.LiteBlend(lite.parameterize_sources(
        sources, obs, getattr(lite, param)), obs)


def build_blend(lite, d):
    return parameterized(lite, build_seeds(lite, d))


def setup_blends(dev):
    """Generate the blends (fixed seed), initialize them on the host and
    pack them on the card.  Returns (single, (config, data, state), init
    seconds, seeds); ``single`` is a separately built copy of the first
    blend, for ``LiteBlend.fit``; ``seeds`` the host init's (sources,
    observation) of each blend, for other parameterizations."""
    from scarlet_tpu_torch import lite, parallel
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(SEED)
    raw = [generate_blend(rng) for _ in range(N_BLENDS)]
    t0 = time.perf_counter()
    seeds = [build_seeds(lite, d) for d in raw]
    blends = [parameterized(lite, sd) for sd in seeds]
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
    return build_blend(lite, raw[0]), setup, init_s, seeds


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
                     2 * nbytes(morphs) + nbytes(idx)
                     + taps_bytes(idx, wt, kt),
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
    return stack_blends(N_HET, HET_SEED)


def stack_blends(n, seed, shape=(5, 58, 48)):
    """n generated blends of ``shape`` (``default_rng(seed)``), stacked and
    packed to one catalog layout (numpy)."""
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(seed)
    blends = [generate_blend(rng, shape=shape) for _ in range(n)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((n, K, 2), np.int32)
    active = np.zeros((n, K), bool)
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
        **bound(2 * nbytes(morphs) + nbytes(stepped, idx, thr, gate)
                + taps_bytes(idx, wt, kt),
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
        **bound(nbytes(morphs, grads, *opt, masks, gate, thr, ds)
                + taps_bytes(fidx, wt, kt)
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


def _init_decisions_equal(card, cpu, what):
    """The discrete init decisions of two ``stream_setup`` results on the
    same blends: origins, active slots, box masks, slot sources, splits,
    PSF fallbacks, active counts and overflow."""
    pairs = [("origins", card[2].origins[0], cpu[2].origins[0]),
             ("comp_active", card[2].comp_active[0], cpu[2].comp_active[0]),
             ("box_masks", card[1].box_masks[0], cpu[1].box_masks[0])]
    pairs += [(k, card[3][k], cpu[3][k])
              for k in ("slot_source", "split", "psf_fallback", "n_active",
                        "overflow")]
    for name, a, b in pairs:
        if not bool((a.cpu() == b).all()):
            raise AssertionError(f"card and CPU {what} init disagree on "
                                 f"{name}")


def cpu_rerun(dev, het):
    """4 well-conditioned blends initialized and fitted on the card and on
    the CPU (plain versions) at the card's mono_tol: the same discrete
    init decisions, the same final logL."""
    from scarlet_tpu_torch.parallel import batch

    card = het_setup(dev, het, CPU_BLENDS)
    cfg = card[0]
    cpu = het_setup("cpu", het, CPU_BLENDS, mono_tol=cfg.mono_tol)
    _init_decisions_equal(card, cpu, "stream")
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
    then K1's own cost per pass beside ``full``'s (their ratio must lie in
    ``K1_OVER_FULL``), the parts of K1's pass, and the passes per K1
    launch it implies beside the ``exact`` counts ({"fit": ...,
    "kernel_phase": ...} mean passes per morphology).  Returns (kernel
    entry, launches, report)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.tools import mono_pass_attrib as tool

    t_phase = time.perf_counter()
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
    # 8 passes of every slot: the morphologies in and out and the slots'
    # compact taps (what the kernel reads of the tables); the work of the
    # nonzero taps of candidate 0
    taps = kn._device_taps(wsel, keepsel, kn._variant_maker("full"))
    res = dict(
        **bound(2 * nbytes(packed) + nbytes(*taps[:3]),
                mono_ops(torch.full((tool.B, tool.K), 8, device=dev), idx0,
                         wtab)),
        max_abs_err=max(errs.values()),
        limit="0; alu8 1e-6 of max |plain| (fused multiply-add)",
        errors_by_variant=errs,
        # device time; CUDA events around one call, as earlier runs timed
        # it, also count the wrapper's host time before the launch
        ms=device_ms(lambda: full(kn.mono_pass_variant), "mix_kernel"),
        event_ms=time_ms(lambda: full(kn.mono_pass_variant), 10),
        plain_ms=time_ms(lambda: full(kn.mono_pass_variant_plain), 3),
        shape=f"variant full, 8 passes, B={tool.B} x ({tool.S},"
              f"{tool.K * tool.S})")
    log(f"kernel mono_pass_variant: kernel {res['ms']:.4f} ms device "
        f"({res['event_ms']:.4f} ms events around a call), plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']} ({res['bound_bytes']} B) "
        f"[{res['shape']}] on {card}")

    kn.reset_launch_counts()
    report = tool.attribute(dev, reps=9, log=log)
    launches = kn.launch_counts()["mono_pass_variant"]
    print(json.dumps(report), flush=True)
    if report["full_vs_production_max_diff"] != 0.0:
        raise AssertionError("variant full differs from K1: "
                             f"{report['full_vs_production_max_diff']}")
    # K1's own cost per pass beside full's, on the same input and card,
    # at forced pass counts, the two timed in one queue per round
    # (tool.k1_over_full): another process on the card lands its time
    # slices on long kernels, so the tool's full (calls of up to 3 ms)
    # against K1 timed after it can read far from 1 on a sound kernel
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
    turns = tool.k1_over_full(dev, K1_ROUNDS, K1_COUNTS)
    k1_slope, beside = turns["k1"], turns["full"]
    per_round = turns["over_full_by_round"]
    k1_slope.update(over_full=turns["over_full"], full_in_turns=beside,
                    over_full_by_round=per_round)
    full_slope = report["variants"]["full"]["us_per_pass_per_blend"]
    k1_slope["over_tool_full"] = (k1_slope["us_per_pass_per_blend"]
                                  / full_slope)
    report["k1"] = k1_slope
    at = {name: [round(m, 4) for m in turns[name]["ms_at_counts"].values()]
          for name in ("k1", "full")}
    log(f"K1 (monotonic_prox_packed) {k1_slope['us_per_pass_per_blend']:.5f}"
        f" us/pass/blend, overhead {k1_slope['overhead_us_per_blend']:.4f} "
        f"us/blend, r2 {k1_slope['r2']:.6f}; full in turns with it "
        f"{beside['us_per_pass_per_blend']:.5f} us/pass/blend, overhead "
        f"{beside['overhead_us_per_blend']:.4f} us/blend, r2 "
        f"{beside['r2']:.6f} (device ms, least of {K1_ROUNDS} rounds, at "
        f"{K1_COUNTS}: K1 {at['k1']}, full {at['full']}): "
        f"K1 / full = {k1_slope['over_full']:.4f} (limits {K1_OVER_FULL}; "
        f"by round {min(per_round):.4f}-{max(per_round):.4f}); K1 over the "
        f"tool's full ({full_slope:.5f} us/pass/blend, passes "
        f"{tool.COUNTS}) {k1_slope['over_tool_full']:.4f}; K1 at 32 passes "
        f"equals full (max diff {k1_full_err}); on {card}")
    inflated = full_slope / beside["us_per_pass_per_blend"]
    if abs(inflated - 1) > 0.1:
        # the tool times each count as the least of 9 runs of 3 calls of
        # up to 3 ms, which a second context on the card slows every time
        log(f"the tool's full ({full_slope:.5f}) is {inflated:.3f} times "
            "full in turns with K1: the card was shared during the "
            "tool's run, whose slopes and parts below are inflated")
    lo, hi = K1_OVER_FULL
    if not lo <= k1_slope["over_full"] <= hi:
        raise AssertionError(f"K1 / full = {k1_slope['over_full']:.4f}: "
                             "T1 does not time the pass K1 runs")
    parts = report["derived_us_per_pass_per_blend"]
    slopes = {m: v["us_per_pass_per_blend"]
              for m, v in report["variants"].items()}
    log("K1's pass, us per pass per blend (T1, the same run): full "
        f"{full_slope:.5f}; its neighbour loads (full - norolls) "
        f"{parts['neighbour_loads']:.5f} "
        f"({100 * parts['neighbour_loads'] / full_slope:.1f}%), its test "
        f"(full - noreduce) {parts['convergence_test']:.5f} "
        f"({100 * parts['convergence_test'] / full_slope:.1f}%), a test "
        f"every 8 passes would save {parts['unroll8_saving']:.5f} "
        f"({100 * parts['unroll8_saving'] / full_slope:.1f}%); "
        f"rollsonly (4 halo loads, no taps) {slopes['rollsonly']:.5f}, "
        f"alu8 (8 chained FMAs) {slopes['alu8']:.5f}, norolls in bf16x2 "
        f"{slopes['bf16']:.5f} (norolls / bf16 "
        f"{parts['norolls_over_bf16']:.3f}); on {card}")

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
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"the T1 phase took {res['phase_s']:.1f} s")
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


def wavelet_path(dev, card, het, main_dev_s):
    """The het stream with ``recipe="wavelets"`` (warm-up, three runs from
    numpy, three device-resident) beside the main recipe's
    device-resident median; ``stream_setup`` per chunk for both recipes
    and the monotonic-mask closure's passes and host reads per call; 4
    blends' init decisions and final logL against the CPU; chunk 0 with
    ``use_mask=True``; one ``centers=None`` wavelet run.  Returns
    (launch counts of one run, summary)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.ops import prox
    from scarlet_tpu_torch.parallel import batch, stream

    mp = model_psf()
    wav = dict(recipe="wavelets")

    def run(images, variance, psfs, centers=het["centers"], **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = stream.deblend_device_stream(
            images, variance, psfs, centers, mp, device=dev,
            **({} if centers is None else dict(center_active=het["active"])),
            **dict(HET, **wav, **kw))
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

    records = res[0]
    for i, r in enumerate(records):
        if not (np.isfinite(r["logL"]) and np.isfinite(r["init logL"])
                and np.all(np.isfinite(r["flux"]))):
            raise AssertionError(f"wavelet record {i} is not finite")
    worse = [i for i, r in enumerate(records)
             if not r["logL"] > r["init logL"]]
    log(f"wavelet stream blends whose final logL is not above their "
        f"initial one: {worse}")
    if len(worse) > MAX_WORSE * len(records):
        raise AssertionError(f"logL did not improve for {len(worse)} of "
                             f"{len(records)} wavelet-stream blends")
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "wavelet path")

    # stream_setup alone per chunk of 128 (device-resident, synchronized)
    # for both recipes, and the closure's work in one wavelet call
    sl = slice(0, HET["chunk"])
    chunk_in = [x[sl] for x in dev_in]
    setup_kw = dict(center_active=het["active"][sl],
                    box_size=HET["box_size"], n_slots=HET["n_slots"],
                    device=dev)

    def setup_s(**kw):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream.stream_setup(*chunk_in, het["centers"][sl], mp,
                                **setup_kw, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    def closure_work(**kw):
        """The closure's passes and host reads (``prox.mask_counts``) in one
        ``stream_setup`` call, and the device ms of the kernels launched in
        its ``torch.profiler`` range with the range's host ms (profiled)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):     # the profiler has come back empty-handed once
            prox.reset_mask_counts()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                stream.stream_setup(*chunk_in, het["centers"][sl], mp,
                                    **setup_kw, **kw)
                torch.cuda.synchronize()
            counts = prox.mask_counts()
            ranges = [e for e in p.events()
                      if e.name == "monotonic_mask_device"
                      and e.device_type == DeviceType.CPU]
            dev_us = sum(getattr(e, "device_time_total", None)
                         or getattr(e, "cuda_time_total", 0.0)
                         for e in ranges)
            if len(ranges) == 1 and dev_us > 0:
                return (counts["passes"], counts["host_syncs"], dev_us / 1e3,
                        ranges[0].time_range.elapsed_us() / 1e3)
        raise AssertionError("the profiler recorded no closure kernel")

    setup_wav_s, setup_main_s = setup_s(**wav), setup_s()
    passes, syncs, closure_ms, closure_host_ms = closure_work(**wav)

    # 4 well-conditioned blends on the card and on the CPU (plain
    # versions), fitted with the card's config at e_rel 0
    card_b = het_setup(dev, het, CPU_BLENDS, **wav)
    cfg = dataclasses.replace(card_b[0], e_rel=0.0)
    cpu_b = het_setup("cpu", het, CPU_BLENDS, **wav)
    _init_decisions_equal(card_b, cpu_b, "wavelet")
    finals = []
    t0 = time.perf_counter()
    for _, data, state, _ in (card_b, cpu_b):
        out, _ = batch.fit_batch_device_converged(
            state, data, cfg, WAVELET_CPU_ITERS, HET["check_every"])
        finals.append(out.last_loss.cpu().numpy())
    cpu_s = time.perf_counter() - t0
    rel = np.abs(finals[1] - finals[0]) / np.abs(finals[0])
    log(f"wavelet CPU rerun of het blends {CPU_BLENDS}, "
        f"{WAVELET_CPU_ITERS} iterations at e_rel 0 ({cpu_s:.1f} s): init "
        f"decisions equal; logL {finals[1]} vs card {finals[0]}, max rel "
        f"diff {rel.max():.3g} (limit {CPU_RTOL})")
    if not rel.max() <= CPU_RTOL:
        raise AssertionError("CPU and card wavelet-stream logL disagree")

    # the main recipe with the monotonic-mask seeds on chunk 0: no K1
    # launch in the init, K1 in the fit; the CPU's decisions on 4 blends
    kn.reset_launch_counts()
    mask_passes, mask_syncs, mask_closure_ms, mask_closure_host_ms = \
        closure_work(use_mask=True)
    mcfg, mdata, mstate, maux = stream.stream_setup(
        *chunk_in, het["centers"][sl], mp, **setup_kw, use_mask=True)
    init_k1 = kn.launch_counts()["monotonic_prox"]
    out, losses = batch.fit_batch_device_converged(
        mstate, mdata, mcfg, HET["max_iter"], HET["check_every"])
    fit_k1 = kn.launch_counts()["monotonic_prox"] - init_k1
    mrec = stream.stream_records(out, losses, maux)
    if init_k1 != 0 or fit_k1 <= 0:
        raise AssertionError(f"use_mask: K1 launched {init_k1} times in the "
                             f"init and {fit_k1} in the fit")
    if not all(np.isfinite(r["logL"]) and np.all(np.isfinite(r["flux"]))
               for r in mrec):
        raise AssertionError("a use_mask record is not finite")
    _init_decisions_equal(het_setup(dev, het, CPU_BLENDS, use_mask=True),
                          het_setup("cpu", het, CPU_BLENDS, use_mask=True),
                          "use_mask")

    # device detection feeding the wavelet recipe
    m = REDETECT_BLENDS
    dres, det_s = run(*(x[:m] for x in host_in), centers=None)
    if not all(np.isfinite(r["logL"]) for r in dres[0]):
        raise AssertionError("a centers=None wavelet record is not finite")

    its = np.array([r["iterations"] for r in records])
    wav_dev = float(np.median(dev_times))
    summary = dict(
        wavelet_blends_per_min=N_HET / float(np.median(host_times)) * 60.0,
        wall_s=sorted(host_times), warmup_s=warm_s,
        device_resident_blends_per_min=N_HET / wav_dev * 60.0,
        device_resident_wall_s=sorted(dev_times),
        main_device_resident_blends_per_min=N_HET / main_dev_s * 60.0,
        main_device_resident_s=main_dev_s,
        setup_wavelets_s_per_chunk=setup_wav_s,
        setup_main_s_per_chunk=setup_main_s,
        closure_passes_per_setup=passes, closure_host_reads_per_setup=syncs,
        closure_device_ms_per_setup=closure_ms,
        closure_range_host_ms_per_setup=closure_host_ms,
        mask_closure_passes_per_setup=mask_passes,
        mask_closure_host_reads_per_setup=mask_syncs,
        mask_closure_device_ms_per_setup=mask_closure_ms,
        mask_closure_range_host_ms_per_setup=mask_closure_host_ms,
        median_iterations=float(np.median(its)),
        iterations_sum=int(its.sum()),
        mean_components=float(np.mean([r["n_components"] for r in records])),
        overflow=int(sum(r["overflow"] for r in records)),
        retried=int(sum(bool(r.get("overflow_retried")) for r in records)),
        cpu_rerun_max_rel=float(rel.max()), cpu_rerun_s=cpu_s,
        use_mask_fit_k1_launches=int(fit_k1),
        use_mask_median_iterations=float(np.median(
            [r["iterations"] for r in mrec])),
        centers_none_blends=m, centers_none_wall_s=det_s)
    log(f"wavelet stream of {N_HET} het blends on {dev}: "
        f"{summary['wavelet_blends_per_min']:.1f} blends/min from numpy "
        f"(walls {[round(x, 3) for x in sorted(host_times)]} s, warm-up "
        f"{warm_s:.2f} s), {summary['device_resident_blends_per_min']:.1f} "
        f"device-resident vs the main recipe's "
        f"{summary['main_device_resident_blends_per_min']:.1f} (medians "
        f"{wav_dev:.4f} vs {main_dev_s:.4f} s); stream_setup per chunk of "
        f"{HET['chunk']}: wavelets {setup_wav_s:.4f} s, main "
        f"{setup_main_s:.4f} s; mask closure per wavelet stream_setup: "
        f"{passes} passes, {syncs} host reads, {closure_ms:.4f} device ms, "
        f"{closure_host_ms:.4f} host ms profiled (use_mask: {mask_passes}, "
        f"{mask_syncs}, {mask_closure_ms:.4f}, {mask_closure_host_ms:.4f}); "
        f"median "
        f"iterations {summary['median_iterations']}; "
        f"{summary['mean_components']:.2f} components per blend; overflow "
        f"{summary['overflow']} (retried {summary['retried']}); use_mask "
        f"chunk 0: K1 0 launches in the init, {fit_k1} in the fit; "
        f"centers=None on {m} blends {det_s:.3f} s; on {card}")
    log(f"wavelet kernel launches (one run): {counts}")
    return counts, summary


# ---------------------------------------------------------------------------
# 8. The fit options: K1 with one tolerance per blend, the matmul DFT,
# box growth, the scheduled tolerance and FISTA
# ---------------------------------------------------------------------------
TOL_MIX = (0.0, 1e-3, 1e6)      # per-blend tolerances of K1's tensor mode
DFT_ITERS = 15      # loss trajectories, DFT against FFT
DFT_RUNS = 3        # converged fits of each mode, in turns
DFT_RTOL = 1e-4     # the JAX package's bound (tests/test_parallel.py:234)
# a relative change of the images at float32 roundoff: how many blends it
# parts from their own FFT fit beyond DFT_RTOL says how many are
# ill-conditioned under the fit (PERF.md, ROADMAP Queue 3 traps)
PERTURB = 1e-7
SCHEDULE = dict(mono_tol_early=1e-2, mono_tol_switch=10)
BOX_GROW = 0.1
GROW_ITERS = 60     # the oversized source (tests/test_box_growth.py)


def tol_tensor_phase(dev, card, het):
    """K1 and K2 with one exit tolerance per blend, read on the card, at
    the stream's shapes (chunk 0: its box-masked morphologies, candidate
    tables and the het set's tables), mixing TOL_MIX: bit for bit against
    the plain version; a tensor filled with a static tolerance gives the
    float launch's bits; the kernel's time with the tensor beside its time
    with the float (the same work), in turns."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn

    config, data, state, _ = het_setup(dev, het, slice(0, HET["chunk"]))
    wt, kt = data.mono_weights[0], data.mono_keep[0]
    n_iter = config.mono_n_iters[0]
    morphs = (state.morphs[0] * data.box_masks[0]).contiguous()
    B, K, hb, wb = morphs.shape
    idx = kn.candidate_index(morphs, 1)
    tols = torch.tensor(TOL_MIX, device=dev)[
        torch.arange(B, device=dev) % len(TOL_MIX)]

    def run(f, tol):
        return f(morphs, idx, wt, kt, n_iter, tol=tol)

    got = run(kn.monotonic_prox, tols)
    ref = run(kn.monotonic_prox_plain, tols)
    err = float((got - ref).abs().max())
    packed = morphs.transpose(-3, -2).reshape(B, hb, K * wb).contiguous()
    got_p = kn.monotonic_prox_packed(packed, idx, wt, kt, wb, n_iter,
                                     tol=tols)
    err_p = float((got_p.reshape(B, hb, K, wb).transpose(-3, -2)
                   - ref).abs().max())
    same, timing = {}, {}
    for tol in (0.0, 1e-3):
        full = torch.full((B,), tol, device=dev)
        same[tol] = bool(torch.equal(run(kn.monotonic_prox, full),
                                     run(kn.monotonic_prox, tol)))
        # float, tensor, tensor, float, float, tensor: the kernel's device
        # time (median of 20 launches each), and CUDA events around the
        # call, which also count the wrapper's host work
        order = (tol, full, full, tol, tol, full)
        t = [device_ms(lambda a=a: run(kn.monotonic_prox, a), "mono_kernel")
             for a in order]
        e = [time_ms(lambda a=a: run(kn.monotonic_prox, a), 20)
             for a in order]
        timing[tol] = dict(float_ms=[t[0], t[3], t[4]],
                           tensor_ms=[t[1], t[2], t[5]],
                           float_event_ms=[e[0], e[3], e[4]],
                           tensor_event_ms=[e[1], e[2], e[5]])
    if err or err_p or not all(same.values()):
        raise AssertionError(f"K1 with a tolerance per blend differs from "
                             f"its plain version ({err}, packed {err_p}) "
                             f"or from the float launch ({same})")
    passes = mono_passes_run(morphs, idx, wt, kt, n_iter, tols)
    res = dict(
        **bound(2 * nbytes(morphs) + nbytes(idx, tols)
                + taps_bytes(idx, wt, kt),
                mono_ops(passes, idx, wt)),
        mean_passes=float(passes.double().mean()),
        mean_passes_by_tol={str(t): float(passes[tols == t].double().mean())
                            for t in TOL_MIX},
        max_abs_err=max(err, err_p), limit=0.0,
        ms=time_ms(lambda: run(kn.monotonic_prox, tols), 10),
        plain_ms=time_ms(lambda: run(kn.monotonic_prox_plain, tols), 3),
        tensor_equals_float=same, float_vs_tensor=timing,
        shape=f"B={B} K={K} box={hb} n_iter={n_iter} tol per blend "
              f"{TOL_MIX} in turns")
    log(f"kernel monotonic_prox with a tolerance per blend: max_abs_err "
        f"{res['max_abs_err']:.3g} (limit 0, K1 and K2), a tensor of the "
        f"static tolerance gives the float launch's bits {same}; kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms by {res['bound_by']}, passes per "
        f"morphology {res['mean_passes_by_tol']} [{res['shape']}] on {card}")
    for tol, t in timing.items():
        # the tensor's median against the float's, beside the spread of
        # the float's own three runs
        fm = float(np.median(t["float_ms"]))
        gap = (float(np.median(t["tensor_ms"])) - fm) / fm
        spread = (max(t["float_ms"]) - min(t["float_ms"])) / fm
        t.update(gap=gap, float_spread=spread)
        log(f"  tol {tol}: kernel device ms, float "
            f"{[round(x, 4) for x in t['float_ms']]}, tensor "
            f"{[round(x, 4) for x in t['tensor_ms']]} (medians of 20, in "
            f"turns): the per-blend read "
            f"{'costs nothing measurable' if abs(gap) <= spread else 'differs'}"
            f" (median gap {100 * gap:+.2f}%, float spread "
            f"{100 * spread:.2f}%); events around the call, float "
            f"{[round(x, 4) for x in t['float_event_ms']]}, tensor "
            f"{[round(x, 4) for x in t['tensor_event_ms']]} ms on {card}")
    return res


def _rel_trajectories(a, b):
    """Per blend, the largest relative difference of two loss
    trajectories (n_iter, B)."""
    a, b = a.cpu().double().numpy(), b.cpu().double().numpy()
    return (np.abs(a - b) / np.abs(b)).max(axis=0)


def _profile_iterations(state, data, cfg, n_iter=10):
    """Device busy ms, summed kernel ms and kernel launches per fit
    iteration of ``cfg`` (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from scarlet_tpu_torch.lite import engine

    engine.fit_scan(state, data, cfg, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.fit_scan(state, data, cfg, n_iter)
        torch.cuda.synchronize()
    kern, busy_us, _ = device_busy(prof)
    return dict(busy_ms_per_iteration=busy_us / n_iter / 1e3,
                kernel_ms_per_iteration=sum(
                    e.time_range.elapsed_us() for e in kern) / n_iter / 1e3,
                launches_per_iteration=len(kern) / n_iter)


def _bpm_in_turns(state, data, cfgs, runs=DFT_RUNS):
    """Converged fits (cap MAX_ITER) of each config in turns, after one
    warm-up each: blends/min per run."""
    import torch
    from scarlet_tpu_torch.parallel import batch

    B = state.active.shape[0]
    for cfg in cfgs.values():
        batch.fit_batch_device_converged(state, data, cfg, MAX_ITER,
                                         CHECK_EVERY)
    out = {name: [] for name in cfgs}
    for _ in range(runs):
        for name, cfg in cfgs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch.fit_batch_device_converged(state, data, cfg, MAX_ITER,
                                             CHECK_EVERY)
            torch.cuda.synchronize()
            out[name].append(B / (time.perf_counter() - t0) * 60.0)
    return out


def split_dft(fft, shape, fft_shape, dev):
    """The DFT convolution with the real and imaginary parts kept apart
    (the (re, im) stacks the JAX package stores) in four real products
    over stacked blocks: a yardstick for the port's complex64 products,
    timed here and used nowhere in the port."""
    import torch

    A, B, iA, iB = fft.dft_conv_matrices(shape, fft_shape, np.float32)
    Hf, Hs, Wh = A.shape[1], iA.shape[1], B.shape[2]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    a_ri, b_ri = up(np.concatenate(A, 0)), up(np.concatenate(B, 1))
    ia_blk = up(np.block([[iA[0], -iA[1]], [iA[1], iA[0]]]))
    ib_re = up(np.concatenate([iB[0], -iB[1]], 0))

    def conv(image, kernel_rfft):
        q = torch.matmul(torch.matmul(a_ri, image), b_ri)
        yr = q[..., :Hf, :Wh] - q[..., Hf:, Wh:]
        yi = q[..., :Hf, Wh:] + q[..., Hf:, :Wh]
        kr, ki = kernel_rfft.real, kernel_rfft.imag
        r = torch.matmul(ia_blk, torch.cat([yr * kr - yi * ki,
                                            yr * ki + yi * kr], dim=-2))
        return torch.matmul(torch.cat([r[..., :Hs, :], r[..., Hs:, :]], -1),
                            ib_re)

    return conv


def dft_phase(dev, card, setup, het):
    """The matmul-DFT convolution against cuFFT at the host path's shapes:
    the port's complex64 products beside the split re/im form, against a
    float64 reference with TF32 off and allowed; loss trajectories over
    DFT_ITERS iterations; device ms, summed kernel ms and launches per fit
    iteration; blends/min of both modes in turns with the spread of
    DFT_RUNS runs; on the host path and on het chunk 0."""
    import torch
    from scarlet_tpu_torch.lite import engine
    from scarlet_tpu_torch.ops import fft

    config, data, state = setup
    C, H, W = config.scene_shape
    scene = engine.make_scene(state, config).contiguous()
    kr = data.kernel_rfft
    ops = fft.dft_conv_operators((H, W), config.fft_shape, torch.float32, dev)
    split = split_dft(fft, (H, W), config.fft_shape, dev)
    ref64 = fft.convolve_fft(scene.cpu().double(),
                             kr.cpu().to(torch.complex128), config.fft_shape)
    scale = float(ref64.abs().max())

    def rel_err(out):
        return float((out.cpu().double() - ref64).abs().max()) / scale

    calls = {"fft": lambda: fft.convolve_fft(scene, kr, config.fft_shape),
             "dft": lambda: fft.convolve_dft(scene, kr, ops),
             "split dft (yardstick)": lambda: split(scene, kr)}
    routes = {}
    for name, f in calls.items():
        dms, launches = device_ms_all(f)
        routes[name] = dict(rel_err_tf32_off=rel_err(f()), ms=dms,
                            launches=launches, event_ms=time_ms(f, 20))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for name in ("dft", "split dft (yardstick)"):
            routes[name]["rel_err_tf32_on"] = rel_err(calls[name]())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for name, r in routes.items():
        log(f"convolution {name} at B={scene.shape[0]} C={C} {H}x{W} fft "
            f"{config.fft_shape}: {r['ms']:.4f} ms device in "
            f"{r['launches']:.0f} kernels ({r['event_ms']:.4f} ms events), "
            f"rel err vs float64 {r['rel_err_tf32_off']:.3g} with TF32 off"
            + (f", {r['rel_err_tf32_on']:.3g} with TF32 allowed"
               if "rel_err_tf32_on" in r else "") + f" on {card}")
    if routes["dft"]["rel_err_tf32_off"] > 1e-5:
        raise AssertionError("the DFT convolution is not float32 with TF32 "
                             "off")

    out = dict(routes=routes)
    het_setup_0 = het_setup(dev, het, slice(0, HET["chunk"]))[:3]
    # per blend, DFT_RTOL holds on the het blends a roundoff change of the
    # images leaves in place (CPU_BLENDS); over all blends, the median
    for where, (cfg, dat, st), strict in (("host path", setup, []),
                                          ("het chunk 0", het_setup_0,
                                           CPU_BLENDS)):
        cfgs = {"fft": cfg, "dft": dataclasses.replace(cfg, conv_mode="dft")}
        _, l_fft = engine.fit_scan(st, dat, cfgs["fft"], DFT_ITERS)
        _, l_dft = engine.fit_scan(st, dat, cfgs["dft"], DFT_ITERS)
        rel = _rel_trajectories(l_dft, l_fft)
        # the FFT fit against itself on images changed by PERTURB: a blend
        # it parts beyond DFT_RTOL is ill-conditioned under the fit
        _, l_pert = engine.fit_scan(
            st, dat._replace(images=dat.images * (1 + PERTURB)),
            cfgs["fft"], DFT_ITERS)
        rel_p = _rel_trajectories(l_pert, l_fft)
        far = np.flatnonzero(rel > DFT_RTOL).tolist()
        moved = np.flatnonzero(rel_p > DFT_RTOL).tolist()
        if not (np.isfinite(l_dft.cpu().numpy()).all()
                and np.median(rel) <= FUSED_MEDIAN_RTOL
                and all(rel[b] <= DFT_RTOL for b in strict)):
            raise AssertionError(
                f"DFT and FFT trajectories part on the {where}: median "
                f"{np.median(rel)}, blends {strict}: {rel[strict]}")
        prof = {m: _profile_iterations(st, dat, c) for m, c in cfgs.items()}
        bpm = _bpm_in_turns(st, dat, cfgs)
        out[where] = dict(median_rel=float(np.median(rel)),
                          max_rel=float(rel.max()), blends_beyond=far,
                          perturbed_beyond=moved,
                          perturbed_median_rel=float(np.median(rel_p)),
                          strict_blends=strict,
                          strict_max_rel=float(rel[strict].max())
                          if strict else None,
                          profile=prof, blends_per_min=bpm)
        log(f"DFT vs FFT on the {where} ({st.active.shape[0]} blends, "
            f"{DFT_ITERS} iterations): loss trajectories median rel diff "
            f"{np.median(rel):.3g} (limit {FUSED_MEDIAN_RTOL}), max "
            f"{rel.max():.3g}"
            + (f", blends {strict} {rel[strict].max():.3g} (limit "
               f"{DFT_RTOL})" if strict else "")
            + f"; {len(far)} blends beyond {DFT_RTOL} ({far}); the FFT fit "
            f"against itself on images changed by {PERTURB}: median "
            f"{np.median(rel_p):.3g}, {len(moved)} blends beyond ({moved}): "
            "ill-conditioned blends part at roundoff")
        for m in cfgs:
            p = prof[m]
            log(f"  {m}: {p['busy_ms_per_iteration']:.4f} ms device busy "
                f"and {p['kernel_ms_per_iteration']:.4f} ms of kernels per "
                f"iteration, {p['launches_per_iteration']:.1f} launches per "
                f"iteration; blends/min "
                f"{[round(x, 1) for x in bpm[m]]} (median "
                f"{np.median(bpm[m]):.1f}, spread "
                f"{min(bpm[m]):.1f}..{max(bpm[m]):.1f}) on {card}")
    return out


def _states(st):
    return st if isinstance(st, list) else [st]


def grow_schedule_phase(dev, card, het):
    """The het stream (256 blends, chunks of 128, box 59, 16 slots, cap
    100) with ``box_grow`` and with the scheduled tolerance: one warm-up,
    then one run with the launch counts zeroed before it; records finite,
    blends/min, median iterations; under the schedule no blend frozen
    before the switch and K1's per-blend mode launched; with growth the
    grown slots, each with a step scale below 1.  Returns ({form: launch
    counts}, summary)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import stream

    mp = model_psf()
    counts, summary = {}, {}
    for form, kw in (("box_grow", dict(box_grow=BOX_GROW)),
                     ("schedule", SCHEDULE)):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = stream.deblend_device_stream(
                het["images"], het["variance"], het["psfs"], het["centers"],
                mp, center_active=het["active"], device=dev,
                **dict(HET, **kw))
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        run()
        kn.reset_launch_counts()
        (records, state, _, _), wall = run()
        counts[form] = kn.launch_counts()
        for name in PATH_KERNELS:
            if counts[form][name] <= 0:
                raise AssertionError(f"{name} was not launched in the "
                                     f"{form} stream")
        if not all(np.isfinite(r["logL"]) and np.all(np.isfinite(r["flux"]))
                   for r in records):
            raise AssertionError(f"a {form} record is not finite")
        worse = [i for i, r in enumerate(records)
                 if not r["logL"] > r["init logL"]]
        if len(worse) > MAX_WORSE * len(records):
            raise AssertionError(f"{form}: logL did not improve for "
                                 f"{len(worse)} blends")
        its = np.array([r["iterations"] for r in records])
        res = dict(blends_per_min=N_HET / wall * 60.0, wall_s=wall,
                   median_iterations=float(np.median(its)),
                   min_iterations=int(its.min()), worse=worse)
        if form == "schedule":
            # a blend frozen at it ends with it + 1 iterations, and it must
            # pass the switch: at least switch + 2 (or the cap)
            if its.min() < min(SCHEDULE["mono_tol_switch"] + 2,
                               HET["max_iter"]):
                raise AssertionError(f"a blend froze before iteration "
                                     f"{SCHEDULE['mono_tol_switch']}")
            if counts[form]["monotonic_prox_tol_tensor"] <= 0:
                raise AssertionError("the scheduled stream did not read its "
                                     "tolerance per blend")
        else:
            halves = [s.box_half[0].cpu() for s in _states(state)]
            scales = [s.step_scale[0].cpu() for s in _states(state)]
            grown = sum(int((h >= 0).sum()) for h in halves)
            if not all(bool((sc[h >= 0] < 1.0).all())
                       for h, sc in zip(halves, scales)):
                raise AssertionError("a grown slot kept its step")
            res.update(grown_slots=grown, active_slots=int(sum(
                s.comp_active[0].sum() for s in _states(state))),
                largest_half=max(int(h.max()) for h in halves))
        summary[form] = res
        log(f"het stream with {form} {kw}: {res['blends_per_min']:.1f} "
            f"blends/min from numpy ({wall:.3f} s), median iterations "
            f"{res['median_iterations']}, fewest {res['min_iterations']}"
            + (f"; {res['grown_slots']} of {res['active_slots']} slots grew "
               f"(largest half-size {res['largest_half']}), each with a step "
               f"scale < 1" if form == "box_grow" else
               f"; no blend froze before iteration "
               f"{SCHEDULE['mono_tol_switch']}")
            + f"; launches {counts[form]} on {card}")
    return counts, summary


def oversized_growth(dev, card):
    """The oversized-source case of tests/test_box_growth.py in the port,
    on the card and on the CPU with the card's config (plain versions):
    the same grown half-sizes and step scales, logL rtol CPU_RTOL."""
    import torch
    from scipy.signal import fftconvolve
    from scarlet_tpu_torch import lite
    from scarlet_tpu_torch.parallel import batch, stream

    rng = np.random.default_rng(0)
    C, H, W = 3, 64, 64
    yy, xx = np.mgrid[:H, :W]
    prof = np.exp(-np.hypot(yy - 32, xx - 32) / 6.0).astype(np.float32)
    sed = np.asarray([1.0, 2.0, 1.5], np.float32)
    psf = lite.integrated_circular_gaussian(sigma=1.2).astype(np.float32)
    truth = sed[:, None, None] * prof[None] * 30.0
    images = np.stack([fftconvolve(truth[c], psf, mode="same")
                       for c in range(C)]).astype(np.float32)
    variance = np.full_like(images, 0.01)
    images += rng.standard_normal(images.shape).astype(np.float32) * 0.1
    args = (images[None], variance[None], psf[None].repeat(C, 0)[None],
            np.asarray([[[32, 32]]]), model_psf())
    bm = np.zeros((1, 2, 59, 59), np.float32)
    bm[:, :, 22:37, 22:37] = 1.0      # half-size 7
    outs = {}
    cfg = None
    for where in (dev, "cpu"):
        c, d, st, _ = stream.stream_setup(
            *args, box_size=59, n_slots=2, box_grow=BOX_GROW, device=where)
        cfg = c if cfg is None else cfg     # the card's, on both
        d = d._replace(box_masks=(torch.from_numpy(bm).to(where),))
        outs[str(where)], _ = batch.fit_batch_device_converged(
            st, d, cfg, GROW_ITERS, 20)
    card_o, cpu_o = outs[str(dev)], outs["cpu"]
    half, scale = card_o.box_half[0].cpu(), card_o.step_scale[0].cpu()
    same = bool((half == cpu_o.box_half[0]).all()
                and (scale == cpu_o.step_scale[0]).all())
    rel = abs(float(card_o.last_loss[0]) - float(cpu_o.last_loss[0])) \
        / abs(float(cpu_o.last_loss[0]))
    log(f"oversized source, {GROW_ITERS} iterations with box_grow "
        f"{BOX_GROW}: card half-sizes {half.tolist()}, step scales "
        f"{scale.tolist()} (CPU the same: {same}); logL "
        f"{float(card_o.last_loss[0]):.6g} vs CPU "
        f"{float(cpu_o.last_loss[0]):.6g}, rel diff {rel:.3g} (limit "
        f"{CPU_RTOL}) on {card}")
    if not (same and rel <= CPU_RTOL and int(half.max()) > 7):
        raise AssertionError("the oversized source grew otherwise on the "
                             "card than on the CPU")
    return dict(box_half=half.tolist(), step_scale=scale.tolist(),
                logL=float(card_o.last_loss[0]), cpu_rel=rel)


def fista_host_path(dev, card, seeds):
    """The host path with FISTA: the host init's seeds through
    ``init_fista_component``, ``pack_blends`` on the card and
    ``fit_batch_device_converged``; logL finite and improving, N_CPU
    blends within CPU_RTOL of their CPU refit.  Returns (launch counts,
    summary)."""
    import torch
    from scarlet_tpu_torch import lite, parallel
    from scarlet_tpu_torch.ops import kernels as kn

    blends = [parameterized(lite, sd, "init_fista_component")
              for sd in seeds]
    config, data, state = parallel.pack_blends(blends, e_rel=E_REL,
                                               device=dev)
    if config.optimizer != "fista":
        raise AssertionError(f"pack_blends chose {config.optimizer}")
    parallel.fit_batch_device_converged(state, data, config, MAX_ITER,
                                        CHECK_EVERY)
    kn.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, losses = parallel.fit_batch_device_converged(
        state, data, config, MAX_ITER, check_every=CHECK_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kn.launch_counts()
    losses, final = losses.cpu().numpy(), out.last_loss.cpu().numpy()
    if not (np.isfinite(losses).all() and np.isfinite(final).all()):
        raise AssertionError("non-finite logL in the FISTA fit")
    worse = np.flatnonzero(final <= losses[0]).tolist()
    if len(worse) > MAX_WORSE * len(final):
        raise AssertionError(f"FISTA: logL did not improve for {worse}")
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the FISTA fit")
    sel = list(range(N_CPU))
    cdata, cstate = parallel.select_blends(data, state, sel, device="cpu")
    cout, _ = parallel.fit_batch_device_converged(cstate, cdata, config,
                                                  MAX_ITER, CHECK_EVERY)
    rel = np.abs(cout.last_loss.numpy() - final[sel]) / np.abs(final[sel])
    its = out.it.cpu().numpy()
    summary = dict(blends_per_min=len(final) / wall * 60.0, wall_s=wall,
                   median_iterations=float(np.median(its)), worse=worse,
                   cpu_max_rel=float(rel.max()))
    log(f"FISTA host path, {len(final)} blends: {summary['blends_per_min']:.1f}"
        f" blends/min ({wall:.3f} s), median iterations "
        f"{summary['median_iterations']}, logL not above its start for "
        f"{worse}; CPU refit of blends {sel}: max rel diff {rel.max():.3g} "
        f"(limit {CPU_RTOL}); launches {counts} on {card}")
    if not rel.max() <= CPU_RTOL:
        raise AssertionError("CPU and card FISTA logL disagree")
    return counts, summary


# ---------------------------------------------------------------------------
# The multi-resolution fit (tools/multires_bench.py's configuration)
# ---------------------------------------------------------------------------
def sdr(truth, model):
    """Source distortion ratio in dB (tests/test_multiresolution.py:28)."""
    return 10 * np.log10(np.sum(truth ** 2) ** 0.5
                         / np.sum((truth - model) ** 2) ** 0.5)


def multires_setup(dev, rotation, B=MR_B):
    """The synthetic HR + LR pair at full width on ``dev``: observations
    (hr, lr), the model frame, B flux-scaled stacks (``default_rng(0)``,
    as tools/multires_bench.py:36-41), weights 400 and the host init of
    the three blobs' sky positions."""
    from scarlet_tpu_torch import models, parallel
    from scarlet_tpu_torch.testing import blob_centers, make_pair

    obs_hr, obs_lr, data_hr, data_lr = make_pair(rotation_lr=rotation,
                                                 device=dev)
    frame = models.Frame.from_observations([obs_lr, obs_hr], obs_id=1)
    rng = np.random.default_rng(0)
    sc = (0.8 + 0.4 * rng.random(B).astype(np.float32))[:, None, None, None]
    datas = (np.repeat(data_hr[None][None], B, 0) * sc,
             np.repeat(data_lr[None][None], B, 0) * sc)
    weights = tuple(np.full_like(d, 400.0) for d in datas)
    obs = (obs_hr, obs_lr)
    init = parallel.multires_init(obs, datas, blob_centers(frame, B),
                                  box_size=MR_BOX, n_slots=MR_SLOTS)
    return obs, frame, datas, weights, init


def cpu_pair(rotation, dtype=np.float32):
    """The pair's observations (hr, lr) on the CPU, matched to their model
    frame in ``dtype``."""
    from scarlet_tpu_torch import models
    from scarlet_tpu_torch.testing import make_pair

    obs_hr, obs_lr, _, _ = make_pair(rotation_lr=rotation, device="cpu")
    frame = models.Frame.from_observations([obs_lr, obs_hr], obs_id=1)
    if dtype != np.float32:
        frame.dtype = dtype
        for o in (obs_hr, obs_lr):
            o.match(frame)
    return (obs_hr, obs_lr), frame


def multires_profile(fit, n_iter=20):
    """Device time by kernel group over an ``n_iter``-iteration fit
    (``torch.profiler``): K1, K3, K4, cuFFT, matmul and the rest, per
    iteration, launches per iteration and the device's busy share of the
    wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fit(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(n_iter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, busy_us, _ = device_busy(prof)
    groups = {"K1": ("mono_kernel",), "K3": ("scene_kernel",),
              "K4": ("grad_kernel",), "cuFFT": ("fft",),
              "matmul": ("gemm", "xmma", "cutlass")}
    ms = {k: 0.0 for k in (*groups, "other")}
    for e in kern:
        name = e.name.lower()
        key = next((k for k, keys in groups.items()
                    if any(s in name for s in keys)), "other")
        ms[key] += e.time_range.elapsed_us() / n_iter / 1e3
    return dict(device_ms_per_iteration=ms,
                launches_per_iteration=len(kern) / n_iter,
                busy_share=busy_us / 1e6 / wall, profiled_wall_s=wall)


def multires_fit_runs(fitter, datas, weights, init, n_iter, label, card):
    """One warm-up fit, then MR_RUNS timed fits (host clock, ending at
    ``torch.cuda.synchronize()``), the kernel counts zeroed just before
    the first and read just after it.  Returns (output, counts, summary)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn

    def fit(n=n_iter):
        return fitter.fit(datas, weights, *init, n_iter=n)

    fit()
    torch.cuda.synchronize()
    walls, counts = [], None
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MR_RUNS):
        if counts is None:
            kn.reset_launch_counts()
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if counts is None:
            counts = kn.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the {label} "
                                 f"multi-resolution fit")
    B = out[0].shape[0]
    med = float(np.median(walls))
    its = out[3].cpu().numpy()
    losses = out[4].cpu().numpy()
    if not np.isfinite(losses).all() or not (out[2].cpu().numpy()
                                             < losses[0]).all():
        raise AssertionError(f"{label} multi-resolution fit: non-finite "
                             f"or not improving losses")
    ran = fitter.iterations_run_
    prof = multires_profile(fit)
    summary = dict(blends_per_min=B / med * 60.0, wall_s=walls,
                   ms_per_iteration=med / ran * 1e3, iterations_run=ran,
                   median_iterations=float(np.median(its)),
                   peak_memory_bytes=int(peak), launches=counts, **prof)
    dm = prof["device_ms_per_iteration"]
    log(f"multi-resolution {label} pair, B={B} box {MR_BOX} {MR_SLOTS} slots"
        f", cap {n_iter}: {summary['blends_per_min']:.1f} blends/min "
        f"(walls {[round(w, 4) for w in walls]} s), "
        f"{summary['ms_per_iteration']:.4f} ms/iteration over "
        f"{ran} iterations run, median iterations "
        f"{summary['median_iterations']}; peak memory "
        f"{peak / 2 ** 20:.1f} MiB; profiled 20 iterations: device busy "
        f"{100 * prof['busy_share']:.1f}% of the wall, "
        f"{prof['launches_per_iteration']:.1f} launches/iteration, device "
        f"ms/iteration " + ", ".join(f"{k} {v:.4f}" for k, v in dm.items())
        + f"; launches in one fit {counts} on {card}")
    return out, counts, summary


def multires_sdr(fitter, datas, out, init, label, lr_min, frozen):
    """Every blend's HR and LR renders against its data: SDR above 10 dB
    (HR) and ``lr_min`` (LR), the JAX tests' limits.  ``frozen`` maps the
    one blend the reference itself leaves below a limit to the iteration
    at which its stop rule ``|dL| < e_rel |L|`` fires, on a plateau of
    adaprox's non-monotone trajectory (tests/test_torch_multires.py::
    test_stop_rule_freezes_like_jax): that blend passes only if the card
    freezes it at that iteration too.  Any other blend below a limit
    fails."""
    def sdrs(renders):
        return np.asarray([[sdr(d[b, 0], r[b, 0].cpu().numpy())
                            for b in range(len(d))]
                           for d, r in zip(datas, renders)])

    B = len(datas[0])
    got = sdrs(fitter.render_batch(out[0], out[1], init[2], init[3]))
    low = np.flatnonzero((got[0] <= 10) | (got[1] <= lr_min))
    its = out[3].cpu().numpy()
    lo = [float(got[0].min()), float(got[1].min())]
    log(f"multi-resolution {label}: SDR over {B} blends HR "
        f"{lo[0]:.2f}..{float(got[0].max()):.2f} dB (limit 10), LR "
        f"{lo[1]:.2f}..{float(got[1].max()):.2f} dB (limit {lr_min}); "
        f"below a limit: blends {low.tolist()} (SDR HR "
        f"{np.round(got[0, low], 2).tolist()}, LR "
        f"{np.round(got[1, low], 2).tolist()}) at iterations "
        f"{its[low].tolist()}; the reference's own {frozen}")
    bad = [int(b) for b in low if frozen.get(int(b)) != its[b]]
    if bad:
        raise AssertionError(f"{label}: blends {bad} are below their SDR "
                             f"limit")
    return dict(hr_min=lo[0], lr_min=lo[1], below=low.tolist(),
                below_iterations=its[low].tolist())


def multires_render_error(fitter, rotation, out, init, label, card):
    """Blend 0's card renders (float32, TF32 off) against a float64 CPU
    render of the same scene (the renderers rebuilt in float64), and the
    LR render with TF32 allowed for contrast: the largest error over the
    largest value."""
    import torch
    from scarlet_tpu_torch.parallel import multires

    (obs_hr, obs_lr), frame = cpu_pair(rotation, np.float64)
    scene = multires.assemble_scene(
        *(t[:1].cpu().double() for t in out[:2]),
        torch.from_numpy(init[2][:1]), torch.from_numpy(init[3][:1]),
        frame.shape)
    refs = [o.render(scene)[0].numpy() for o in (obs_hr, obs_lr)]

    def err(r, ref):
        return float(np.abs(r - ref).max() / np.abs(ref).max())

    renders = fitter.render_batch(out[0][:1], out[1][:1], init[2][:1],
                                  init[3][:1])
    errs = [err(r[0].cpu().numpy(), ref) for r, ref in zip(renders, refs)]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fitter.render_batch(out[0][:1], out[1][:1], init[2][:1],
                                   init[3][:1])[1][0].cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = err(tf32, refs[1])
    log(f"multi-resolution {label}: blend 0's card render against a float64 "
        f"CPU render, largest error / largest value: HR {errs[0]:.3g}, LR "
        f"{errs[1]:.3g} with TF32 off (limit {MR_F64_RTOL}); LR "
        f"{tf32_err:.3g} with TF32 allowed, on {card}")
    if max(errs) > MR_F64_RTOL:
        raise AssertionError(f"{label}: the card's render is off the "
                             f"float64 render by {max(errs)}")
    return dict(hr=errs[0], lr=errs[1], lr_tf32_allowed=tf32_err)


def multires_cpu_rerun(obs, datas, weights, init, card):
    """MR_CPU_BLENDS blends over MR_CPU_ITERS iterations on the card and
    on the CPU (plain versions): the loss histories within CPU_RTOL."""
    from scarlet_tpu_torch import parallel

    sel = slice(0, MR_CPU_BLENDS)
    part = lambda xs: tuple(x[sel] for x in xs)  # noqa: E731
    hists = []
    for observations in (obs, cpu_pair(0.0)[0]):
        fitter = parallel.MultiResFitter(observations, box_size=MR_BOX)
        out = fitter.fit(part(datas), part(weights), *part(init),
                         n_iter=MR_CPU_ITERS)
        hists.append(out[4].cpu().numpy())
    rel = float((np.abs(hists[0] - hists[1]) / np.abs(hists[1])).max())
    log(f"multi-resolution card vs CPU, {MR_CPU_BLENDS} blends x "
        f"{MR_CPU_ITERS} iterations: loss histories max rel diff "
        f"{rel:.3g} (limit {CPU_RTOL}), final {hists[0][-1]} vs "
        f"{hists[1][-1]} on {card}")
    if rel > CPU_RTOL:
        raise AssertionError("card and CPU multi-resolution fits disagree")
    return rel


def multires_kernel_checks(fitter, seds, morphs, origins, on, label, card):
    """K1, K3 and K4 against their plain versions at one multi-resolution
    path's shapes: its fitted seds, morphologies, origins and slots; K1 on
    the morphologies plus noise (a prox input), with the fit's centred
    table at tol 0; K4 on a contiguous gradient of the scene's shape (as
    the renderers' backward gives it) at pad 0."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn

    seds, morphs = seds.contiguous(), morphs.contiguous()
    dev = seds.device
    origins = torch.from_numpy(origins).to(dev)
    on = torch.from_numpy(on).to(dev)
    B, K, S, _ = morphs.shape
    C, H, W = fitter.scene_shape
    shape = f"{label}: B={B} K={K} C={C} {H}x{W} box={S} pad=0"
    res = {"scene_assembly": scene_check(seds, morphs, origins, on,
                                         (C, H, W), 0),
           "grad_gather": grad_check(strided_gradient(B, C, H, W, (H, W),
                                                      dev),
                                     seds, morphs, origins, 0)}
    w8, keep, depth = fitter._mono
    gen = torch.Generator().manual_seed(SEED)
    x = (morphs + 0.05 * torch.randn(morphs.shape, generator=gen).to(dev)
         ).clamp_min(0.0).contiguous()
    idx = torch.zeros((B, K), dtype=torch.int32, device=dev)

    def k1(f):
        return f(x, idx, w8, keep, depth, 0.0, tol=0.0)

    passes = mono_passes_run(x, idx, w8, keep, depth, 0.0)
    res["monotonic_prox"] = dict(
        **bound(2 * nbytes(x) + nbytes(idx) + taps_bytes(idx, w8, keep),
                mono_ops(passes, idx, w8)),
        mean_passes=float(passes.double().mean()),
        max_abs_err=float((k1(kn.monotonic_prox)
                           - k1(kn.monotonic_prox_plain)).abs().max()),
        limit=0.0, ms=device_ms(lambda: k1(kn.monotonic_prox),
                                "mono_kernel"),
        plain_ms=time_ms(lambda: k1(kn.monotonic_prox_plain), 5))
    for name, r in res.items():
        err = r["g_morph_err"] if name == "grad_gather" else r["max_abs_err"]
        if err != 0.0:
            raise AssertionError(f"{name} at the multi-resolution shapes "
                                 f"differs from its plain version by {err}")
        r["shape"] = shape
        log(f"kernel {name} at the multi-resolution shapes: max_abs_err "
            f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms device, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} [{shape}] on {card}")
    return res


def multires_detect(dev, card):
    """``deblend_multires(centers=None)`` on the aligned pair: detection on
    the HR stack, MR_DETECT_SLOTS slots, MR_DETECT_ITERS iterations; every
    blend gets its three blobs near their true positions.  The detection
    alone is timed on the same stack (median of 3 after a warm-up)."""
    import torch
    from scarlet_tpu_torch import parallel
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.testing import blob_centers

    obs, frame, datas, weights, _ = multires_setup(dev, 0.0)
    kn.reset_launch_counts()
    t0 = time.perf_counter()
    recs, seds, morphs, origins, active, losses = parallel.deblend_multires(
        obs, datas, weights, centers=None, box_size=MR_BOX,
        n_slots=MR_DETECT_SLOTS, n_iter=MR_DETECT_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kn.launch_counts()
    checks = multires_kernel_checks(
        parallel.MultiResFitter(obs, box_size=MR_BOX), seds, morphs,
        origins, active, "deblend_multires", card)
    found = active.sum(1)
    true = blob_centers(frame, 1)[0]
    far = max(float(np.linalg.norm(
        np.asarray(r["centroid"])[active[b]][:, None] - true[None],
        axis=-1).min(1).max()) for b, r in enumerate(recs))
    img = torch.from_numpy(datas[0]).to(dev)
    var = torch.full_like(img, 1 / 400.0)
    det = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parallel.detect_peaks_device(img, var, max_peaks=MR_DETECT_SLOTS)
        torch.cuda.synchronize()
        det.append(time.perf_counter() - t0)
    summary = dict(wall_s=wall, blends=len(recs),
                   blends_per_min=len(recs) / wall * 60.0,
                   detect_s=float(np.median(det[1:])),
                   min_found=int(found.min()), max_found=int(found.max()),
                   farthest_centroid_px=far, launches=counts,
                   logL_finite=bool(all(np.isfinite(r["logL"])
                                        for r in recs)))
    log(f"deblend_multires(centers=None) on {len(recs)} aligned blends, "
        f"{MR_DETECT_SLOTS} slots, {MR_DETECT_ITERS} iterations: "
        f"{wall:.3f} s ({summary['blends_per_min']:.1f} blends/min), "
        f"detection alone {summary['detect_s']:.4f} s; sources per blend "
        f"{int(found.min())}..{int(found.max())}, farthest centroid "
        f"{far:.2f} px from its blob; launches {counts} on {card}")
    if not (found == 3).all() or far >= 5.0 or not summary["logL_finite"]:
        raise AssertionError("deblend_multires missed a blob")
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by "
                                 "deblend_multires")
    return summary, checks


def multires_phase(dev, card):
    """The multi-resolution path on the card: the aligned and the rotated
    pair at full width, the card against the CPU, the kernels at each
    path's shapes, and ``deblend_multires(centers=None)``.  Returns (the
    aligned fit's launch counts, kernel checks by path, summary)."""
    import torch
    from scarlet_tpu_torch import parallel

    summary, checks = {}, {}
    for label, rotation, n_iter, lr_min, frozen in (
            ("aligned", 0.0, MR_ITERS, 10, MR_SDR_FROZEN),
            ("rotated", MR_ROTATION, MR_ROT_ITERS, 8, {})):
        obs, frame, datas, weights, init = multires_setup(dev, rotation)
        if obs[1].renderer.isrot != (label == "rotated"):
            raise AssertionError(f"the {label} pair got the wrong renderer")
        fitter = parallel.MultiResFitter(obs, box_size=MR_BOX, e_rel=E_REL)
        dd = tuple(torch.from_numpy(d).to(dev) for d in datas)
        ww = tuple(torch.from_numpy(w).to(dev) for w in weights)
        out, path_counts, summary[label] = multires_fit_runs(
            fitter, dd, ww, init, n_iter, label, card)
        if label == "aligned":
            counts = path_counts
        summary[label]["sdr"] = multires_sdr(
            fitter, datas, out, init, label, lr_min, frozen)
        summary[label]["f64_render_error"] = multires_render_error(
            fitter, rotation, out, init, label, card)
        if label == "aligned":
            summary[label]["cpu_rerun_max_rel"] = multires_cpu_rerun(
                obs, datas, weights, init, card)
        checks[label] = multires_kernel_checks(
            fitter, out[0], out[1], init[2], init[3], label, card)
        del fitter, out, dd, ww
    summary["detect"], checks["deblend_multires"] = multires_detect(
        dev, card)
    return counts, checks, summary


# ---------------------------------------------------------------------------
# the object tree: scarlet's quickstart (examples/quickstart.py:22-36)
# ---------------------------------------------------------------------------
def ot_setup(d, dev, set_spectra=True, perturb=None):
    """The quickstart's frame, observation and ``init_all_sources`` on
    ``dev``; with ``perturb`` (a seed), the images times (1 + OT_PERTURB
    * N(0, 1)).  Returns a dict with the init's seconds (host clock,
    synchronized)."""
    import torch
    from scarlet_tpu_torch import initialization

    frame, obs, centers, _ = ot_observation(d, dev, perturb)
    t0 = time.perf_counter()
    sources, skipped = initialization.init_all_sources(
        frame, centers, obs, max_components=2, min_snr=30, silent=True,
        set_spectra=set_spectra)
    if obs.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(frame=frame, obs=obs, sources=sources, skipped=skipped,
                init_s=time.perf_counter() - t0)


def ot_observation(d, dev, perturb=None):
    """The quickstart's frame and observation of blend ``d`` on ``dev``
    (float32 images; with ``perturb`` a seed, the images times (1 +
    OT_PERTURB * N(0, 1))), with its catalog centers and images."""
    from scarlet_tpu_torch import models

    ch = list(d["filters"])
    images = d["images"].astype(np.float64)
    if perturb is not None:
        images *= 1 + OT_PERTURB * np.random.default_rng(
            perturb).standard_normal(images.shape)
    images = images.astype(np.float32)
    frame = models.Frame(images.shape, channels=ch,
                         psf=models.GaussianPSF(sigma=0.8, boxsize=15))
    obs = models.Observation(
        images, ch, psf=models.ImagePSF(d["psfs"]),
        weights=(1 / d["variance"]).astype(np.float32),
        device=dev).match(frame)
    centers = [(float(r["y"]), float(r["x"])) for r in d["catalog"]]
    return frame, obs, centers, images


def ot_decisions(s):
    """The init's discrete decisions: source kinds, component counts,
    boxes and skipped centers."""
    return ([type(x).__name__ for x in s["sources"]],
            [len(x.children) if type(x).__name__ == "MultiExtendedSource"
             else 1 for x in s["sources"]],
            [(tuple(x.bbox.shape), tuple(x.bbox.origin))
             for x in s["sources"]], list(s["skipped"]))


def ot_fit(s, n_iter=OT_MAX_ITER, e_rel=OT_E_REL):
    """``Blend(sources, obs).fit``; returns the blend and its seconds."""
    import torch
    from scarlet_tpu_torch import models

    blend = models.Blend(s["sources"], s["obs"])
    t0 = time.perf_counter()
    blend.fit(n_iter, e_rel=e_rel)
    if s["obs"].device.type == "cuda":
        torch.cuda.synchronize()
    return blend, time.perf_counter() - t0


def ot_chi2(s, blend):
    """chi2 per pixel of the fitted model rendered into the observation."""
    obs = s["obs"]
    model = obs.render(blend.get_model())
    return float((obs.weights * (obs.data - model) ** 2).mean())


def ot_profile(blend, n_iter=OT_PROFILE_ITERS):
    """``n_iter`` more iterations of ``blend``'s fit under
    ``torch.profiler``: device busy share of the wall, kernel launches per
    iteration, K1's device ms and launches per iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = len(blend.loss)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        blend.fit(start + n_iter, e_rel=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(blend.loss) - start
    kern, busy_us, window_us = device_busy(prof)
    k1 = [e for e in kern if "mono_kernel" in e.name]
    return dict(iterations=n, wall_ms_per_iteration=wall * 1e3 / n,
                busy_share=busy_us / 1e6 / wall,
                idle_share_of_span=1.0 - busy_us / window_us,
                device_ms_per_iteration=busy_us / 1e3 / n,
                launches_per_iteration=len(kern) / n,
                k1_launches_per_iteration=len(k1) / n,
                k1_ms_per_iteration=sum(e.time_range.elapsed_us()
                                        for e in k1) / 1e3 / n)


def ot_kernel_checks(dev, card):
    """K1 against its plain version at the object tree's shapes: one
    (1, 1, S, S) morphology per call, S in OT_BOXES, "angle" and "flat"
    tables at min_gradient 0 and 0.1, and the fit_center_radius=1
    candidate table (its index picked on the device); bit for bit; S in
    OT_WIDE_BOXES on ``mono_kernel_wide``.  The angle table at 0 and, for
    S in OT_BOXES, the candidate table are timed (profiler device time;
    the plain version with CUDA events)."""
    import torch
    from scarlet_tpu_torch import models
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.ops import prox

    gen = torch.Generator().manual_seed(SEED)
    out = []
    for S in OT_BOXES + OT_WIDE_BOXES:
        yy, xx = torch.meshgrid(torch.arange(S), torch.arange(S),
                                indexing="ij")
        c = S // 2
        prof = torch.exp(-((yy - c) ** 2 + (xx - c + 1) ** 2) / (S / 3.0))
        x = (prof + 0.05 * torch.randn((S, S), generator=gen)).float()
        x[c - 1, c + 1] = 2.0                 # the peak on the window's edge
        x = x.to(dev)[None, None].contiguous()
        fc = models.MonotonicityConstraint("angle", 0.0, fit_center_radius=1)
        cases = [(nw, mg, [(c, c)], None) for nw in ("angle", "flat")
                 for mg in (0.0, 0.1)]
        cases.append(("angle", 0.0, fc.candidates((S, S)),
                      fc.candidate_index(x[0, 0])))
        for nw, mg, centers, idx in cases:
            wt, kt, depth, idx0 = prox.device_tables(
                (S, S), nw, centers, dev, torch.float32)
            idx = idx0 if idx is None else idx.to(torch.int32)

            def k1(f):
                return f(x, idx, wt, kt, depth, mg, tol=0.0)

            wide = kn.launch_counts()["monotonic_prox_wide"]
            err = float((k1(kn.monotonic_prox)
                         - k1(kn.monotonic_prox_plain)).abs().max())
            wide = kn.launch_counts()["monotonic_prox_wide"] > wide
            if wide != (S in OT_WIDE_BOXES):
                raise AssertionError(f"K1 at ({S}, {S}) ran the "
                                     f"{'wide' if wide else 'register'} "
                                     "kernel")
            table = nw if len(centers) == 1 else \
                f"{nw}, {len(centers)} candidates"
            rec = dict(S=S, table=table, min_gradient=mg, n_iter=depth,
                       max_abs_err=err,
                       kernel="mono_kernel_wide" if wide else "mono_kernel",
                       R=kn._card_geometry(dev, 1, S, S).R if wide else 1,
                       workspace=bool(wide and kn.mono_wide_workspace(S, S)))
            if err != 0.0:
                raise AssertionError(f"K1 at ({S}, {S}) {table} mg {mg} "
                                     f"differs from its plain version by "
                                     f"{err}")
            # timed: the angle table at 0, and on the register kernel the
            # candidate table too (each timing runs the profiler anew)
            if mg == 0.0 and nw == "angle" and (len(centers) == 1
                                                or S in OT_BOXES):
                passes = mono_passes_run(x, idx, wt, kt, depth, 0.0)
                rec.update(
                    **bound(2 * nbytes(x) + nbytes(idx)
                            + taps_bytes(idx, wt, kt),
                            mono_ops(passes, idx, wt)),
                    passes=int(passes.max()),
                    ms=device_ms(lambda: k1(kn.monotonic_prox),
                                 "mono_kernel"),
                    plain_ms=time_ms(lambda: k1(kn.monotonic_prox_plain), 5))
                log(f"kernel monotonic_prox at the object tree's shapes "
                    f"(1, 1, {S}, {S}) {table} ({rec['kernel']}, R={rec['R']}"
                    f"{', planes in device memory' if rec['workspace'] else ''}"
                    f"): bit for bit, kernel "
                    f"{rec['ms']:.4f} ms device, plain {rec['plain_ms']:.4f} "
                    f"ms, bound {rec['bound_ms']:.6f} ms by "
                    f"{rec['bound_by']} at {rec['passes']} passes, on {card}")
            out.append(rec)
    log(f"K1 at the object tree's shapes: {len(out)} cases bit for bit "
        f"(S {OT_BOXES} and, on mono_kernel_wide, {OT_WIDE_BOXES}; "
        f"angle/flat, min_gradient 0/0.1, 9-candidate table)")
    return out


def ot_cpu_run(job):
    """One CPU run for :func:`ot_card_vs_cpu`, in a worker process (one
    thread): ``("blend", i, set_spectra, n_iter, perturb)`` gives the
    init decisions and losses of blend ``i`` of the cell; ``("galaxy",)``
    the losses and boxes of ``testing.large_galaxy_fit``."""
    import torch
    from scarlet_tpu_torch.testing.example_data import ot_blends

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if job[0] == "galaxy":
        from scarlet_tpu_torch.testing import large_galaxy_fit

        blend, boxes = large_galaxy_fit("cpu")
        return boxes, np.array(blend.loss)
    _, i, set_spectra, n_iter, perturb = job
    s = ot_setup(ot_blends(i + 1, OT_SEED, OT_SHAPE, OT_SOURCES)[i], "cpu",
                 set_spectra, perturb)
    blend, _ = ot_fit(s, n_iter, e_rel=0)
    return ot_decisions(s), np.array(blend.loss)


def ot_card_vs_cpu(dev, blends, card):
    """OT_CPU_BLENDS of the cell and the large galaxy on the card and the
    CPU (the CPU runs in worker processes while the card runs).

    Per blend: the init decisions equal and the first loss within
    OT_START_RTOL.  From the quickstart's start (spectra at their joint
    least-squares optimum, where float32 roundoff is amplified), the
    losses of OT_CPU_ITERS iterations, at each iteration, within the
    larger of OT_CPU_RTOL and OT_WITNESS_FACTOR times the CPU's own
    spread so far (the largest difference between two of its runs, on
    the images and on the images perturbed with each of
    OT_WITNESS_SEEDS): before the amplification begins this is
    OT_CPU_RTOL.  From the init without the spectrum solve the losses
    within OT_CPU_RTOL.  The large galaxy (``testing.large_galaxy_fit``,
    its box grown past 73 pixels, K1 on ``mono_kernel_wide``): the boxes
    after each step equal, the losses within OT_CPU_RTOL."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.testing import large_galaxy_fit

    jobs = [("galaxy",)]
    for i in OT_CPU_BLENDS:
        jobs += [("blend", i, True, OT_CPU_ITERS, None),
                 ("blend", i, False, OT_CPU_ITERS, None)]
        jobs += [("blend", i, True, OT_CPU_ITERS, p)
                 for p in OT_WITNESS_SEEDS]
    workers = max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {job: pool.submit(ot_cpu_run, job) for job in jobs}
        card_runs = {}
        for i in OT_CPU_BLENDS:
            for set_spectra in (True, False):
                s = ot_setup(blends[i], dev, set_spectra=set_spectra)
                blend, _ = ot_fit(s, OT_CPU_ITERS, e_rel=0)
                card_runs[i, set_spectra] = (ot_decisions(s),
                                             np.array(blend.loss))
        kn.reset_launch_counts()
        galaxy, galaxy_boxes = large_galaxy_fit(dev)
        torch.cuda.synchronize()
        galaxy_wide = kn.launch_counts()["monotonic_prox_wide"]
        cpu = {job: f.result(timeout=900) for job, f in futures.items()}

    out = dict(blends={})
    for i in OT_CPU_BLENDS:
        rec = out["blends"][i] = {}
        for set_spectra in (True, False):
            dc, lc = card_runs[i, set_spectra]
            dh, lh = cpu["blend", i, set_spectra, OT_CPU_ITERS, None]
            if dc != dh:
                raise AssertionError(f"blend {i}: card and CPU init "
                                     f"decisions differ: {dc} / {dh}")
            if abs(lc[0] - lh[0]) > OT_START_RTOL * abs(lh[0]):
                raise AssertionError(f"blend {i}: first loss card {lc[0]} "
                                     f"CPU {lh[0]}")
            rel = np.abs(lc - lh) / np.abs(lh)
            if not set_spectra:
                rec["no_solve_max_rel"] = float(rel.max())
                if rel.max() > OT_CPU_RTOL:
                    raise AssertionError(
                        f"blend {i}: card and CPU losses part by "
                        f"{rel.max()} (> {OT_CPU_RTOL}) from the init "
                        "without the spectrum solve")
                continue
            runs = [lh] + [cpu["blend", i, True, OT_CPU_ITERS, p][1]
                           for p in OT_WITNESS_SEEDS]
            spread = np.zeros_like(rel)
            for a in range(len(runs)):
                for b in range(a):
                    spread = np.maximum(
                        spread, np.abs(runs[a] - runs[b]) / np.abs(lh))
            rec["witness_max_rel"] = [float(np.max(np.abs(r - lh)
                                                   / np.abs(lh)))
                                      for r in runs[1:]]
            rec["spread_iteration_1"] = float(spread[1])
            rec["card_iteration_1"] = float(rel[1])
            limit = np.maximum(OT_CPU_RTOL, OT_WITNESS_FACTOR
                               * np.maximum.accumulate(spread))
            over = np.flatnonzero(rel > limit)
            amplified = np.flatnonzero(spread > OT_CPU_RTOL)
            start = int(amplified[0]) if amplified.size else len(rel)
            rec.update(quickstart_max_rel=float(rel.max()),
                       quickstart_rel_before_amplification=float(
                           rel[:start].max()) if start else None,
                       amplification_iteration=start)
            if over.size:
                t = int(over[0])
                raise AssertionError(
                    f"blend {i}: card and CPU losses part by {rel[t]} at "
                    f"iteration {t}, over {limit[t]} (the larger of "
                    f"{OT_CPU_RTOL} and {OT_WITNESS_FACTOR} x the CPU's "
                    f"own spread {spread[:t + 1].max()})")
    boxes_h, loss_h = cpu["galaxy",]
    rel = float(np.max(np.abs(np.array(galaxy.loss) - loss_h)
                       / np.abs(loss_h)))
    out["galaxy"] = dict(boxes=[list(b) for b in galaxy_boxes],
                         k1_wide_launches=int(galaxy_wide), max_rel=rel)
    if galaxy_boxes != boxes_h or max(galaxy_boxes[-1]) <= 73:
        raise AssertionError(f"large galaxy boxes card {galaxy_boxes} CPU "
                             f"{boxes_h}")
    if galaxy_wide == 0:
        raise AssertionError("the large galaxy's fit launched no "
                             "mono_kernel_wide")
    if rel > OT_CPU_RTOL:
        raise AssertionError(f"large galaxy: card and CPU losses part by "
                             f"{rel} (> {OT_CPU_RTOL})")
    for i, rec in out["blends"].items():
        log(f"object tree card vs CPU, blend {i}: init decisions equal, "
            f"first loss within {OT_START_RTOL}; {OT_CPU_ITERS} iterations "
            f"from the quickstart start: max rel "
            f"{rec['quickstart_max_rel']:.3g} (the CPU against itself on "
            f"perturbed images, seeds {list(OT_WITNESS_SEEDS)}: "
            f"{[float(f'{w:.3g}') for w in rec['witness_max_rel']]}; at "
            f"iteration 1 the card {rec['card_iteration_1']:.3g}, the "
            f"CPU's runs {rec['spread_iteration_1']:.3g} apart at most; "
            f"amplified past {OT_CPU_RTOL} from iteration "
            f"{rec['amplification_iteration']}, card vs CPU before it "
            f"{rec['quickstart_rel_before_amplification']}); from the init "
            f"without the spectrum solve: max rel "
            f"{rec['no_solve_max_rel']:.3g} (limit {OT_CPU_RTOL}), on {card}")
    g = out["galaxy"]
    log(f"object tree large galaxy (box grown past 73): boxes {g['boxes']} "
        f"on the card and the CPU, {g['k1_wide_launches']} mono_kernel_wide "
        f"launches, losses max rel {g['max_rel']:.3g} (limit {OT_CPU_RTOL}), "
        f"on {card}")
    return out


def object_tree_phase(dev, card):
    """The object tree on the card: K1 at its shapes, the quickstart cell
    (OT_BLENDS blends in turn, one warm-up first), a profile of 20
    iterations, the large scene, the card against the CPU.  Returns (the
    cell's launch counts, K1's checks, summary)."""
    import torch
    from scarlet_tpu_torch.testing.example_data import ot_blends
    from scarlet_tpu_torch import measure
    from scarlet_tpu_torch.ops import kernels as kn

    t_phase = time.perf_counter()
    checks = ot_kernel_checks(dev, card)
    parts = dict(kernel_checks=time.perf_counter() - t_phase)
    blends = ot_blends(OT_BLENDS, OT_SEED, OT_SHAPE, OT_SOURCES)
    ot_fit(ot_setup(blends[0], dev))           # warm-up

    kn.reset_launch_counts()
    t0 = time.perf_counter()
    recs = []
    for d in blends:
        s = ot_setup(d, dev)
        blend, fit_s = ot_fit(s)
        flux = np.array([measure.flux(src) for src in s["sources"]])
        recs.append(dict(
            iterations=len(blend.loss), init_s=s["init_s"], fit_s=fit_s,
            ms_per_iteration=fit_s * 1e3 / len(blend.loss),
            logL_start=float(blend.log_likelihood[0]),
            logL_end=float(blend.log_likelihood[-1]),
            chi2_dof=ot_chi2(s, blend), sources=len(s["sources"]),
            components=sum(ot_decisions(s)[1]), skipped=len(s["skipped"]),
            flux_finite=bool(np.all(np.isfinite(flux)))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kn.launch_counts()
    bad = [i for i, r in enumerate(recs)
           if not (r["flux_finite"] and np.isfinite(r["logL_end"])
                   and r["logL_end"] > r["logL_start"])]
    if bad:
        raise AssertionError(f"object tree blends {bad}: flux or logL not "
                             "finite, or logL not improved")
    if counts["monotonic_prox"] == 0:
        raise AssertionError("the object tree's fit launched no K1")
    its = sum(r["iterations"] for r in recs)
    chi2 = [r["chi2_dof"] for r in recs]
    if np.median(chi2) > 2.0:
        raise AssertionError(f"object tree chi2/dof median {np.median(chi2)}")
    summary = dict(
        blends=len(recs), blends_per_min=len(recs) * 60.0 / wall,
        wall_s=wall, init_s_per_blend=float(np.mean(
            [r["init_s"] for r in recs])),
        median_iterations=float(np.median([r["iterations"] for r in recs])),
        ms_per_iteration=float(np.median([r["ms_per_iteration"]
                                          for r in recs])),
        chi2_dof_median=float(np.median(chi2)),
        chi2_dof_range=[float(min(chi2)), float(max(chi2))],
        logL_start_median=float(np.median([r["logL_start"] for r in recs])),
        logL_end_median=float(np.median([r["logL_end"] for r in recs])),
        components=[r["components"] for r in recs],
        k1_launches=int(counts["monotonic_prox"]),
        k1_launches_per_iteration=counts["monotonic_prox"] / its)
    log(f"object tree quickstart cell, {len(recs)} blends {OT_SHAPE} x "
        f"{OT_SOURCES} sources: {summary['blends_per_min']:.1f} blends/min "
        f"(wall {wall:.2f} s), init {summary['init_s_per_blend']:.3f} s per "
        f"blend, median {summary['median_iterations']:.0f} iterations, "
        f"{summary['ms_per_iteration']:.2f} ms per iteration, chi2/dof "
        f"median {summary['chi2_dof_median']:.4f} "
        f"({summary['chi2_dof_range'][0]:.4f}..{summary['chi2_dof_range'][1]:.4f}), "
        f"logL median {summary['logL_start_median']:.1f} -> "
        f"{summary['logL_end_median']:.1f}, K1 {counts['monotonic_prox']} "
        f"launches ({summary['k1_launches_per_iteration']:.1f} per "
        f"iteration), on {card}")

    parts["cell"] = time.perf_counter() - t_phase - sum(parts.values())
    s = ot_setup(blends[1], dev)
    blend, _ = ot_fit(s, 2, e_rel=0)
    summary["profile"] = ot_profile(blend)
    p = summary["profile"]
    log(f"object tree profile of {p['iterations']} iterations: "
        f"{p['wall_ms_per_iteration']:.2f} ms per iteration, device busy "
        f"{100 * p['busy_share']:.1f}% of the wall ({p['device_ms_per_iteration']:.3f} "
        f"ms per iteration; idle {100 * p['idle_share_of_span']:.1f}% of "
        f"the kernels' span), {p['launches_per_iteration']:.1f} launches "
        f"per iteration, K1 {p['k1_launches_per_iteration']:.1f} launches "
        f"and {p['k1_ms_per_iteration']:.4f} ms per iteration, on {card}")

    large = ot_blends(1, OT_SEED + 1, OT_LARGE_SHAPE, OT_LARGE_SOURCES)[0]
    kn.reset_launch_counts()
    s = ot_setup(large, dev)
    torch.cuda.reset_peak_memory_stats()
    blend, fit_s = ot_fit(s, OT_LARGE_ITERS, e_rel=0)
    large_counts = kn.launch_counts()
    prof = ot_profile(blend, OT_LARGE_PROFILE_ITERS)
    summary["large"] = dict(
        shape=list(OT_LARGE_SHAPE), sources=len(s["sources"]),
        components=sum(ot_decisions(s)[1]), init_s=s["init_s"],
        iterations=OT_LARGE_ITERS,
        ms_per_iteration=fit_s * 1e3 / OT_LARGE_ITERS,
        busy_share=prof["busy_share"],
        launches_per_iteration=prof["launches_per_iteration"],
        peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        k1_launches=int(large_counts["monotonic_prox"]),
        k1_wide_launches=int(large_counts["monotonic_prox_wide"]),
        chi2_dof=ot_chi2(s, blend),
        logL=[float(blend.log_likelihood[0]),
              float(blend.log_likelihood[-1])])
    lg = summary["large"]
    if not (np.isfinite(lg["logL"][1]) and lg["logL"][1] > lg["logL"][0]):
        raise AssertionError(f"large scene logL {lg['logL']}")
    log(f"object tree large scene {OT_LARGE_SHAPE} x {lg['sources']} "
        f"sources ({lg['components']} components): "
        f"{lg['ms_per_iteration']:.2f} ms per iteration over "
        f"{OT_LARGE_ITERS}, device busy {100 * lg['busy_share']:.1f}% (a "
        f"profile of {OT_LARGE_PROFILE_ITERS} more), "
        f"{lg['launches_per_iteration']:.1f} launches per iteration, K1 "
        f"{lg['k1_launches']} launches over init and fit "
        f"({lg['k1_wide_launches']} on mono_kernel_wide), peak "
        f"{lg['peak_mib']:.1f} MiB, init {lg['init_s']:.2f} s, chi2/dof "
        f"{lg['chi2_dof']:.4f}, on {card}")

    parts["profile_and_large"] = time.perf_counter() - t_phase \
        - sum(parts.values())
    summary["card_vs_cpu"] = ot_card_vs_cpu(dev, blends, card)
    parts["card_vs_cpu"] = time.perf_counter() - t_phase - sum(parts.values())
    summary["phase_s"] = time.perf_counter() - t_phase
    summary["phase_parts_s"] = parts
    return counts, checks, summary


# ---------------------------------------------------------------------------
# the starlet recipes: the reference's wavelet_model tutorial, as the JAX
# package's examples/starlet_source.py and examples/lsbg_wavelet_model.py
# run it, on the object tree's generated blends
# ---------------------------------------------------------------------------
def sl_setup(d, dev, perturb=None):
    """examples/starlet_source.py's init on blend ``d``: starlet detection
    (``detect.get_peaks``), the first catalog source a StarletSource, the
    others SingleExtendedSources.  Returns a dict with the init's seconds
    (host clock, synchronized) and the peaks matched to the catalog."""
    import torch
    from scarlet_tpu_torch import detect, models

    frame, obs, centers, images = ot_observation(d, dev, perturb)
    t0 = time.perf_counter()
    peaks = detect.get_peaks(images=images,
                             variance=d["variance"].astype(np.float32))
    sources = [models.StarletSource(frame, centers[0], obs,
                                    starlet_thresh=SL_THRESH)]
    sources += [models.SingleExtendedSource(frame, c, obs)
                for c in centers[1:]]
    if obs.device.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    matched = sum(
        1 for c in centers if peaks and min(
            np.hypot(py - c[0], px - c[1]) for py, px in peaks) <= SL_MATCH_PX)
    return dict(frame=frame, obs=obs, sources=sources, peaks=peaks,
                catalog=len(centers), matched=matched, init_s=init_s)


def sl_decisions(s):
    """The init's discrete decisions (peaks, source kinds, boxes) and the
    starlet seed's coefficients (host numpy)."""
    return ([tuple(p) for p in s["peaks"]],
            [(type(x).__name__, tuple(x.bbox.shape), tuple(x.bbox.origin))
             for x in s["sources"]],
            s["sources"][0].parameters[1].host().copy())


def lsbg_decisions(s):
    """The LSBG init's decisions (source kinds and boxes) and the
    full-frame starlet seed's coefficients (host numpy)."""
    return ([(type(x).__name__, tuple(x.bbox.shape), tuple(x.bbox.origin))
             for x in s["sources"]],
            s["sources"][-1].parameters[1].host().copy())


def lsbg_setup(d, dev, perturb=None):
    """examples/lsbg_wavelet_model.py's init: compact sources from
    ``init_all_sources(max_components=1, min_snr=50, thresh=1,
    fallback=True, set_spectra=False)`` at the catalog, then
    ``np.random.seed(0)`` and a full-frame ``StarletSource(frame)``."""
    import torch
    from scarlet_tpu_torch import initialization, models

    frame, obs, centers, _ = ot_observation(d, dev, perturb)
    t0 = time.perf_counter()
    sources, skipped = initialization.init_all_sources(
        frame, centers, obs, max_components=1, min_snr=50, thresh=1,
        fallback=True, silent=True, set_spectra=False)
    np.random.seed(0)
    sources.append(models.StarletSource(frame))
    if obs.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(frame=frame, obs=obs, sources=sources, skipped=skipped,
                init_s=time.perf_counter() - t0)


def starlet_boxes(s):
    """The StarletMorphologies' boxes (shape, origin) of a recipe."""
    from scarlet_tpu_torch import models

    return [(tuple(x.children[1].bbox.shape), tuple(x.children[1].bbox.origin))
            for x in s["sources"]
            if isinstance(x, models.StarletSource)]


def sl_cpu_run(job):
    """One CPU run for :func:`sl_card_vs_cpu` in a worker process (one
    thread): ``("starlet", i, perturb)`` blend ``i`` of the cell,
    ``("lsbg", perturb)`` the field; SL_CPU_ITERS iterations at e_rel 0.
    Returns (init decisions, losses, the starlet boxes after the fit)."""
    import torch
    from scarlet_tpu_torch.testing.example_data import (lsbg_images,
                                                         ot_blends)

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if job[0] == "lsbg":
        s = lsbg_setup(lsbg_images(ot_blends(
            1, OT_SEED + 1, OT_LARGE_SHAPE, OT_LARGE_SOURCES)[0],
            LSBG_RADIUS, LSBG_PEAK)[0], "cpu",
            job[1])
        dec = lsbg_decisions(s)
    else:
        _, i, perturb = job
        s = sl_setup(ot_blends(i + 1, OT_SEED, OT_SHAPE, OT_SOURCES)[i],
                     "cpu", perturb)
        dec = sl_decisions(s)
    blend, _ = ot_fit(s, SL_CPU_ITERS, e_rel=0)
    return dec, np.array(blend.loss), starlet_boxes(s)


def _same_decisions(card, cpu, what):
    """Equal discrete decisions, and seed coefficients within SL_SEED_RTOL
    of their largest value (the last item of each)."""
    if card[:-1] != cpu[:-1]:
        raise AssertionError(f"{what}: card and CPU init decisions differ: "
                             f"{card[:-1]} / {cpu[:-1]}")
    a, b = card[-1], cpu[-1]
    err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    if a.shape != b.shape or err > SL_SEED_RTOL:
        raise AssertionError(f"{what}: starlet seed coefficients part by "
                             f"{err} (> {SL_SEED_RTOL})")
    return err


def sl_card_vs_cpu(dev, blends, lsbg, card):
    """SL_CPU_BLENDS of the cell and the LSBG field on the card and the CPU
    (the CPU in worker processes while the card runs): the init decisions
    (peaks, kinds, boxes) equal and the starlet seeds' coefficients within
    SL_SEED_RTOL; SL_CPU_ITERS iterations' losses within SL_CPU_RTOL at
    every iteration; the StarletMorphologies' boxes after the fit equal.
    The CPU's own spread on images x (1 + OT_PERTURB N(0, 1)) is reported
    beside it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs = [("lsbg", None), ("lsbg", 0)]
    for i in SL_CPU_BLENDS:
        jobs += [("starlet", i, None), ("starlet", i, 0)]
    workers = max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {job: pool.submit(sl_cpu_run, job) for job in jobs}
        card_runs = {}
        for i in SL_CPU_BLENDS:
            s = sl_setup(blends[i], dev)
            dec = sl_decisions(s)
            blend, _ = ot_fit(s, SL_CPU_ITERS, e_rel=0)
            card_runs["starlet", i] = (dec, np.array(blend.loss),
                                       starlet_boxes(s))
        s = lsbg_setup(lsbg, dev)
        dec = lsbg_decisions(s)
        blend, _ = ot_fit(s, SL_CPU_ITERS, e_rel=0)
        card_runs["lsbg"] = (dec, np.array(blend.loss), starlet_boxes(s))
        cpu = {job: f.result(timeout=1200) for job, f in futures.items()}

    out = {}
    for key, what in ([(("starlet", i), f"starlet blend {i}")
                       for i in SL_CPU_BLENDS] + [(("lsbg",), "lsbg field")]):
        dc, lc, bc = card_runs[key if key[0] == "starlet" else "lsbg"]
        dh, lh, bh = cpu[(*key, None)]
        seed_err = _same_decisions(dc, dh, what)
        rel = np.abs(lc - lh) / np.abs(lh)
        spread = np.abs(cpu[(*key, 0)][1] - lh) / np.abs(lh)
        out[what] = dict(max_rel=float(rel.max()), seed_rel=seed_err,
                         cpu_spread_max_rel=float(spread.max()),
                         boxes=[list(map(list, b)) for b in bc])
        if bc != bh:
            raise AssertionError(f"{what}: starlet boxes card {bc} CPU {bh}")
        if rel.max() > SL_CPU_RTOL:
            t = int(np.argmax(rel > SL_CPU_RTOL))
            raise AssertionError(
                f"{what}: card and CPU losses part by {rel[t]} at iteration "
                f"{t} (> {SL_CPU_RTOL}; the CPU against itself on perturbed "
                f"images: {spread.max()})")
        log(f"starlet card vs CPU, {what}: init decisions equal, seed "
            f"coefficients within {seed_err:.3g}, starlet boxes {bc} on both, "
            f"{SL_CPU_ITERS} iterations' losses max rel {rel.max():.3g} "
            f"(limit {SL_CPU_RTOL}; the CPU against itself on images x (1 + "
            f"{OT_PERTURB} N(0, 1)): {spread.max():.3g}), on {card}")
    return out


def starlet_recon_profile(shape, dev, reps=20):
    """Device ms and launches of one starlet reconstruction of ``shape``
    coefficients, forward and autograd backward (what one fit iteration
    of a StarletMorphology runs on the device besides its prox), by
    ``torch.profiler`` over ``reps`` calls each."""
    import torch
    from scarlet_tpu_torch.ops.wavelet import starlet_reconstruction

    c = torch.rand(shape, device=dev, requires_grad=True)
    g = torch.rand(shape[-2:], device=dev)

    def fwd():
        with torch.no_grad():
            starlet_reconstruction(c)

    def fwd_bwd():
        torch.autograd.grad(starlet_reconstruction(c), c, g)

    out = {}
    for label, fn in (("forward", fwd), ("forward_backward", fwd_bwd)):
        kern = kernel_events(fn, reps)
        out[label] = dict(
            launches=len(kern) / reps,
            device_ms=sum(e.time_range.elapsed_us() for e in kern) / 1e3
            / reps)
    out["backward"] = {k: out["forward_backward"][k] - out["forward"][k]
                       for k in ("launches", "device_ms")}
    return out


def _counter(name):
    """A property that reads and writes the wrapped kernel's counter."""
    return property(lambda self: getattr(self.orig, name),
                    lambda self, v: setattr(self.orig, name, v))


class RecordK1:
    """Stands in for ``kernels.monotonic_prox`` while the starlet recipes
    run: keeps a copy of the first input of each (shape, table, depth,
    min_gradient) in ``store`` and calls the wrapper, which launches K1.
    The wrapper counts its launches on the module's ``monotonic_prox``,
    which is this object while it stands in: its counters are the
    wrapper's own, so every launch counts where ``launch_counts`` reads
    it."""

    launches = _counter("launches")
    tol_tensor_launches = _counter("tol_tensor_launches")
    wide_launches = _counter("wide_launches")

    def __init__(self, orig, store):
        self.orig, self.store = orig, store

    def __call__(self, morphs, idx, wt, kt, n, min_gradient=0.0, tol=0.0):
        key = (tuple(morphs.shape), tuple(wt.shape), int(n),
               float(min_gradient))
        if key not in self.store:
            self.store[key] = tuple(t.detach().clone() for t in (
                morphs, idx, wt, kt)) + (n, min_gradient, tol)
        return self.orig(morphs, idx, wt, kt, n, min_gradient, tol)


def sl_kernel_checks(store, card, label="the starlet phase's shapes"):
    """K1 against its plain version on the first input of every shape,
    table and depth the starlet phase (or the path ``label`` names)
    launched: bit for bit.  One record per shape (the inputs checked
    there, their depths, the kernel), with the time of the input of the
    largest depth (profiler device time; the plain version with CUDA
    events)."""
    from scarlet_tpu_torch.ops import kernels as kn

    out = {}
    for key in sorted(store):
        morphs, idx, wt, kt, n, mg, tol = store[key]
        wide = kn.launch_counts()["monotonic_prox_wide"]
        err = float((kn.monotonic_prox(morphs, idx, wt, kt, n, mg, tol=tol)
                     - kn.monotonic_prox_plain(morphs, idx, wt, kt, n, mg,
                                               tol=tol)).abs().max())
        wide = kn.launch_counts()["monotonic_prox_wide"] > wide
        if err != 0.0:
            raise AssertionError(f"K1 at {key} differs from its plain "
                                 f"version by {err}")
        rec = out.setdefault(key[0], dict(
            shape=list(key[0]), inputs=0, n_iter=[n, n], max_abs_err=0.0,
            kernel="mono_kernel_wide" if wide else "mono_kernel"))
        rec["inputs"] += 1
        rec["n_iter"] = [min(rec["n_iter"][0], n), max(rec["n_iter"][1], n)]
        rec["timed_key"] = key
    for shape, rec in out.items():
        morphs, idx, wt, kt, n, mg, tol = store[rec.pop("timed_key")]
        passes = mono_passes_run(morphs, idx, wt, kt, n, tol)

        def k1():
            return kn.monotonic_prox(morphs, idx, wt, kt, n, mg, tol=tol)

        # late in a long run the profiler has come back without any K1
        # event in every window: then CUDA events time the launch
        try:
            ms, timed_by = device_ms(k1, "mono_kernel"), "profiler"
        except AssertionError:
            ms, timed_by = time_ms(k1, 20), "CUDA events"
        rec.update(**bound(2 * nbytes(morphs) + nbytes(idx)
                           + taps_bytes(idx, wt, kt),
                           mono_ops(passes, idx, wt)),
                   passes=int(passes.max()), ms=ms, timed_by=timed_by,
                   plain_ms=time_ms(lambda: kn.monotonic_prox_plain(
                       morphs, idx, wt, kt, n, mg, tol=tol), 5))
        log(f"kernel monotonic_prox at {label} {shape} "
            f"({rec['kernel']}): {rec['inputs']} inputs (depths "
            f"{rec['n_iter'][0]}-{rec['n_iter'][1]}) bit for bit; at depth "
            f"{rec['n_iter'][1]} kernel {rec['ms']:.4f} ms ({timed_by}), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms by "
            f"{rec['bound_by']} at {rec['passes']} passes, on {card}")
    return list(out.values())


def starlet_phase(dev, card):
    """The starlet recipes on the card: (a) examples/starlet_source.py on
    the object tree's 16 blends (one warm-up first), a profile of
    SL_PROFILE_ITERS iterations and the reconstruction's own device cost;
    (b) examples/lsbg_wavelet_model.py on the large scene with a diffuse
    disk; K1 against its plain version on every input shape both
    launched; the card against the CPU.  Returns (the launch counts of (a)
    and (b), K1's checks, summary)."""
    import torch
    from scarlet_tpu_torch.testing.example_data import (lsbg_images,
                                                         ot_blends)
    from scarlet_tpu_torch import measure
    from scarlet_tpu_torch.models import constraint as tcon
    from scarlet_tpu_torch.ops import kernels as kn

    t_phase = time.perf_counter()
    blends = ot_blends(OT_BLENDS, OT_SEED, OT_SHAPE, OT_SOURCES)
    ot_fit(sl_setup(blends[0], dev), SL_MAX_ITER, SL_E_REL)   # warm-up

    store = {}
    orig = kn.monotonic_prox
    kn.monotonic_prox = RecordK1(orig, store)
    try:
        kn.reset_launch_counts()
        t0 = time.perf_counter()
        recs = []
        for d in blends:
            s = sl_setup(d, dev)
            blend, fit_s = ot_fit(s, SL_MAX_ITER, SL_E_REL)
            flux = np.array([measure.flux(src) for src in s["sources"]])
            recs.append(dict(
                iterations=len(blend.loss), init_s=s["init_s"], fit_s=fit_s,
                ms_per_iteration=fit_s * 1e3 / len(blend.loss),
                logL_start=float(blend.log_likelihood[0]),
                logL_end=float(blend.log_likelihood[-1]),
                chi2_dof=ot_chi2(s, blend), peaks=len(s["peaks"]),
                catalog=s["catalog"], matched=s["matched"],
                starlet_box=starlet_boxes(s)[0],
                flux_finite=bool(np.all(np.isfinite(flux)))))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kn.launch_counts()

        lsbg, disk = lsbg_images(ot_blends(1, OT_SEED + 1, OT_LARGE_SHAPE,
                                           OT_LARGE_SOURCES)[0],
                                 LSBG_RADIUS, LSBG_PEAK)
        kn.reset_launch_counts()
        tcon.reset_mask_constraint_counts()
        ls = lsbg_setup(lsbg, dev)
        torch.cuda.reset_peak_memory_stats()
        lblend, lfit_s = ot_fit(ls, LSBG_ITERS, LSBG_E_REL)
        lsbg_counts = kn.launch_counts()
    finally:
        kn.monotonic_prox = orig
    bad = [i for i, r in enumerate(recs)
           if not (r["flux_finite"] and np.isfinite(r["logL_end"])
                   and r["logL_end"] > r["logL_start"])]
    if bad:
        raise AssertionError(f"starlet blends {bad}: flux or logL not "
                             "finite, or logL not improved")
    if counts["monotonic_prox"] == 0 or lsbg_counts["monotonic_prox"] == 0:
        raise AssertionError("a starlet recipe launched no K1")
    its = sum(r["iterations"] for r in recs)
    chi2 = [r["chi2_dof"] for r in recs]
    summary = dict(
        blends=len(recs), blends_per_min=len(recs) * 60.0 / wall,
        wall_s=wall, init_s_per_blend=float(np.mean(
            [r["init_s"] for r in recs])),
        median_iterations=float(np.median([r["iterations"] for r in recs])),
        ms_per_iteration=float(np.median([r["ms_per_iteration"]
                                          for r in recs])),
        chi2_dof_median=float(np.median(chi2)),
        chi2_dof_range=[float(min(chi2)), float(max(chi2))],
        logL_start_median=float(np.median([r["logL_start"] for r in recs])),
        logL_end_median=float(np.median([r["logL_end"] for r in recs])),
        peaks=[r["peaks"] for r in recs],
        catalog_matched=[r["matched"] for r in recs],
        catalog=[r["catalog"] for r in recs],
        starlet_boxes=[r["starlet_box"] for r in recs],
        k1_launches=int(counts["monotonic_prox"]),
        k1_launches_per_iteration=counts["monotonic_prox"] / its)
    log(f"starlet_source recipe, {len(recs)} blends {OT_SHAPE} x "
        f"{OT_SOURCES} sources (the first a StarletSource): "
        f"{summary['blends_per_min']:.1f} blends/min (wall {wall:.2f} s), "
        f"init {summary['init_s_per_blend']:.3f} s per blend, median "
        f"{summary['median_iterations']:.0f} iterations, "
        f"{summary['ms_per_iteration']:.2f} ms per iteration, chi2/dof "
        f"median {summary['chi2_dof_median']:.4f} "
        f"({summary['chi2_dof_range'][0]:.4f}..{summary['chi2_dof_range'][1]:.4f}), "
        f"logL median {summary['logL_start_median']:.1f} -> "
        f"{summary['logL_end_median']:.1f}, K1 {counts['monotonic_prox']} "
        f"launches ({summary['k1_launches_per_iteration']:.1f} per "
        f"iteration), on {card}")
    log("starlet detection (detect.get_peaks) per blend, peaks / catalog "
        "entries / entries with a peak within "
        f"{SL_MATCH_PX} px: " + ", ".join(
            f"{r['peaks']}/{r['catalog']}/{r['matched']}" for r in recs))

    s = sl_setup(blends[1], dev)
    blend, _ = ot_fit(s, 2, e_rel=0)
    summary["profile"] = p = ot_profile(blend, SL_PROFILE_ITERS)
    coeffs = tuple(s["sources"][0].parameters[1].shape)
    p["reconstruction"] = r = starlet_recon_profile(coeffs, dev)
    p["reconstruction_shape"] = list(coeffs)
    log(f"starlet profile of {p['iterations']} iterations: "
        f"{p['wall_ms_per_iteration']:.2f} ms per iteration, device busy "
        f"{100 * p['busy_share']:.1f}% of the wall "
        f"({p['device_ms_per_iteration']:.3f} ms per iteration), "
        f"{p['launches_per_iteration']:.1f} launches per iteration, K1 "
        f"{p['k1_launches_per_iteration']:.1f} launches and "
        f"{p['k1_ms_per_iteration']:.4f} ms per iteration; the starlet "
        f"reconstruction at {coeffs}: forward {r['forward']['launches']:.1f} "
        f"launches, {r['forward']['device_ms']:.4f} ms, backward "
        f"{r['backward']['launches']:.1f} launches, "
        f"{r['backward']['device_ms']:.4f} ms per iteration, on {card}")

    lprof = ot_profile(lblend, OT_LARGE_PROFILE_ITERS)
    diffuse = ls["sources"][-1]
    rendered = float(ls["obs"].render(diffuse.get_model(
        frame=ls["frame"])).sum())
    injected = float(disk.sum())
    lcoeffs = tuple(diffuse.parameters[1].shape)
    summary["lsbg"] = lg = dict(
        shape=list(OT_LARGE_SHAPE), sources=len(ls["sources"]),
        skipped=len(ls["skipped"]), init_s=ls["init_s"],
        iterations=len(lblend.loss),
        ms_per_iteration=lfit_s * 1e3 / len(lblend.loss),
        busy_share=lprof["busy_share"],
        launches_per_iteration=lprof["launches_per_iteration"],
        profile_k1_launches_per_iteration=lprof["k1_launches_per_iteration"],
        peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        k1_launches=int(lsbg_counts["monotonic_prox"]),
        k1_wide_launches=int(lsbg_counts["monotonic_prox_wide"]),
        diffuse_flux=rendered, injected_flux=injected,
        diffuse_coefficients=list(lcoeffs),
        diffuse_box=starlet_boxes(ls)[0],
        reconstruction=starlet_recon_profile(lcoeffs, dev),
        mask_constraint=tcon.mask_constraint_counts(),
        chi2_dof=ot_chi2(ls, lblend),
        logL=[float(lblend.log_likelihood[0]),
              float(lblend.log_likelihood[-1])])
    if not (np.isfinite(lg["logL"][1]) and lg["logL"][1] > lg["logL"][0]):
        raise AssertionError(f"lsbg field logL {lg['logL']}")
    if not rendered > 0:
        raise AssertionError(f"the diffuse starlet source carries no flux: "
                             f"{rendered}")
    lr = lg["reconstruction"]
    log(f"lsbg recipe on the large scene {OT_LARGE_SHAPE} x "
        f"{OT_LARGE_SOURCES} sources plus a diffuse disk (scale radius "
        f"{LSBG_RADIUS} px, peak {LSBG_PEAK} sigma; a stand-in for "
        f"lsbg.pkl): {lg['sources'] - 1} compact sources and a full-frame "
        f"StarletSource of {lcoeffs}; {lg['iterations']} iterations, "
        f"{lg['ms_per_iteration']:.2f} ms per iteration, device busy "
        f"{100 * lg['busy_share']:.1f}% (a profile of "
        f"{OT_LARGE_PROFILE_ITERS} more), {lg['launches_per_iteration']:.1f} "
        f"launches per iteration ("
        f"{lg['profile_k1_launches_per_iteration']:.1f} of them K1), K1 "
        f"{lg['k1_launches']} launches over init "
        f"and fit ({lg['k1_wide_launches']} on mono_kernel_wide), peak "
        f"{lg['peak_mib']:.1f} MiB, the reconstruction forward "
        f"{lr['forward']['launches']:.1f} launches / "
        f"{lr['forward']['device_ms']:.4f} ms and backward "
        f"{lr['backward']['launches']:.1f} / "
        f"{lr['backward']['device_ms']:.4f} ms per iteration; diffuse "
        f"source's rendered flux {rendered:.2f} against the injected disk's "
        f"{injected:.2f} ({rendered / injected:.3f}), box "
        f"{lg['diffuse_box']}, chi2/dof {lg['chi2_dof']:.4f}, init "
        f"{lg['init_s']:.2f} s, on {card}")

    checks = sl_kernel_checks(store, card)
    summary["card_vs_cpu"] = sl_card_vs_cpu(dev, blends, lsbg, card)
    summary["phase_s"] = time.perf_counter() - t_phase
    return counts, lsbg_counts, checks, summary



# the sharded fit: (a) one NCCL rank on the host path's batch, bit for bit
# against fit_batch; (b) two ranks on the one card over gloo, on a batch
# of SH_BANDS-band blends, held to the JAX test's limits
# (tests/test_parallel.py:170-174) against the unsharded card fit
SH_ONE_ITERS = 100
SH_N, SH_BANDS, SH_ITERS, SH_WARM = 128, 4, 20, 2
SH_MESHES = (((1, 2), True), ((2, 1), False))
SH_LOSS_RTOL, SH_STATE_RTOL, SH_STATE_ATOL = 1e-5, 1e-4, 1e-6
# the unsharded fit's own move on images x (1 + SH_PERTURB N(0, 1)): where
# it passes the limits above, the sharded fit may be SH_WITNESS_FACTOR
# times as far (as the object tree's card-vs-CPU check, OT_WITNESS_FACTOR)
SH_PERTURB, SH_WITNESS_FACTOR = 1e-7, 3.0
SH_TIMEOUT_S = 300     # a collective that waits longer fails the run


def _sh_flat(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _sh_flat(t)]
    return [tree]


def _sh_timed(fn, n_iter):
    """(result, ms per iteration) of ``fn()``, a fit of ``n_iter``
    iterations, on the host clock up to ``torch.cuda.synchronize()``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / n_iter


def sharded_one_rank(card, setup):
    """(a) ``fit_batch_sharded`` on a one-rank NCCL mesh against
    ``fit_batch`` on the host path's packed batch: the same bits in every
    leaf of the state and in the losses; in turns (plain, sharded,
    sharded, plain) after a warm-up of each.  Returns (launch counts of
    one sharded fit, summary)."""
    import tempfile
    import torch.distributed as dist
    from scarlet_tpu_torch import parallel
    from scarlet_tpu_torch.ops import kernels as kn

    config, data, state = setup
    n = SH_ONE_ITERS

    def plain():
        return parallel.fit_batch(state, data, config, n)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh()

            def sharded():
                return parallel.fit_batch_sharded(state, data, config, n,
                                                  mesh)

            sharded()
            ref, _ = _sh_timed(plain, n)
            kn.reset_launch_counts()
            out, sh_ms = _sh_timed(sharded, n)
            counts = kn.launch_counts()
            _, sh_ms2 = _sh_timed(sharded, n)
            _, plain_ms2 = _sh_timed(plain, n)
            plain_ms = _sh_timed(plain, n)[1]
            # the call's own cost beside the fit (slicing and the final
            # all-gather of the state): one iteration of each
            gather_ms = _sh_timed(lambda: parallel.fit_batch_sharded(
                state, data, config, 1, mesh), 1)[1] - _sh_timed(
                lambda: parallel.fit_batch(state, data, config, 1), 1)[1]
        finally:
            dist.destroy_process_group()
    leaves_out, leaves_ref = _sh_flat(out), _sh_flat(ref)
    same = [a.device == b.device and bool((a == b).all())
            for a, b in zip(leaves_out, leaves_ref)]
    if len(leaves_out) != len(leaves_ref) or not all(same):
        raise AssertionError(f"one-rank sharded fit differs from fit_batch "
                             f"in {same.count(False)} of {len(same)} leaves")
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the one-rank "
                                 "sharded fit")
    summary = dict(iterations=n, ms_per_iteration=[sh_ms, sh_ms2],
                   fit_batch_ms_per_iteration=[plain_ms2, plain_ms],
                   call_overhead_ms=gather_ms,
                   bitwise_leaves=len(same),
                   launches={k: int(counts[k]) for k in PATH_KERNELS})
    log(f"sharded (a), one NCCL rank, {n} iterations of the host path's "
        f"batch: bit for bit with fit_batch in all {len(same)} leaves; "
        f"{sh_ms:.3f} / {sh_ms2:.3f} ms per iteration against fit_batch's "
        f"{plain_ms2:.3f} / {plain_ms:.3f} (in turns); the call's own "
        f"cost (slicing, the final all-gather; one iteration of each) "
        f"{gather_ms:.3f} ms; "
        f"launches {summary['launches']} on {card}")
    return counts, summary


def sharded_rank(rank, world, tmp):
    """(b) One of two ranks on the one card over gloo: each mesh of
    SH_MESHES after a warm-up of SH_WARM iterations, then SH_ITERS
    iterations with the kernels' launches and the all-reduces counted;
    the global result to ``tmp``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from scarlet_tpu_torch import parallel
    from scarlet_tpu_torch.ops import build
    from scarlet_tpu_torch.ops import kernels as kn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load()
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world,
        timeout=timedelta(seconds=SH_TIMEOUT_S))
    reduces = [0]
    all_reduce = dist.all_reduce

    def counting(*args, **kwargs):
        reduces[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counting
    try:
        config, data, state = torch.load(os.path.join(tmp, "batch.pt"),
                                         weights_only=False)
        res = {}
        for shape, shard_bands in SH_MESHES:
            mesh = parallel.make_mesh(bands=shape[1])
            parallel.fit_batch_sharded(state, data, config, SH_WARM, mesh,
                                       shard_bands=shard_bands)
            kn.reset_launch_counts()
            reduces[0] = 0
            (out, losses), ms = _sh_timed(
                lambda: parallel.fit_batch_sharded(
                    state, data, config, SH_ITERS, mesh,
                    shard_bands=shard_bands), SH_ITERS)
            counts = kn.launch_counts()
            res[shape] = dict(
                losses=losses.cpu(), seds=out.seds[0].cpu(),
                morphs=out.morphs[0].cpu(), ms_per_iteration=ms,
                all_reduces_per_iteration=reduces[0] / SH_ITERS,
                device=str(out.seds[0].device),
                launches={k: int(counts[k]) for k in PATH_KERNELS})
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()


def sharded_batch(dev):
    """SH_N generated (SH_BANDS, 58, 48) blends (``default_rng(SEED)``,
    the first SH_BANDS filters), initialized on the card by
    ``stream_setup`` (box 59, 16 slots), fitted on the unpacked branch
    that the band axis takes and with the exact projection (``mono_tol``
    0, as the JAX test's CPU fit runs it; an exit tolerance would let
    roundoff move whole exit blocks): (config, data, state)."""
    from scarlet_tpu_torch.parallel import stream
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(SEED)
    blends = [generate_blend(rng, shape=(SH_BANDS, 58, 48))
              for _ in range(SH_N)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((SH_N, K, 2), np.int32)
    active = np.zeros((SH_N, K), bool)
    for i, b in enumerate(blends):
        k = len(b["catalog"])
        centers[i, :k, 0] = np.round(b["catalog"]["y"])
        centers[i, :k, 1] = np.round(b["catalog"]["x"])
        active[i, :k] = True
    config, data, state, _ = stream.stream_setup(
        np.stack([b["images"] for b in blends]),
        np.stack([b["variance"] for b in blends]),
        np.stack([b["psfs"] for b in blends]), centers, model_psf(),
        center_active=active, box_size=HET["box_size"],
        n_slots=HET["n_slots"], device=dev)
    return (dataclasses.replace(config, packed_morphs=False, mono_tol=0.0),
            data, state)


def sharded_kernel_checks(dev, card, config, data, state):
    """K1, K3 and K4 against their plain versions at the shapes the two
    meshes give them: K3 and K4 at C = SH_BANDS (the whole batch, and
    half of it on each rank of (2, 1)) and at C = SH_BANDS / 2 (each rank
    of (1, 2)), K1 at half the batch; K3 and K4 bit for bit (g_sed to
    GRAD_SED_RTOL), K1 bit for bit."""
    from scarlet_tpu_torch.ops import kernels as kn

    C, H, W = config.scene_shape
    P = config.pad
    B = state.active.shape[0]
    cases = {"unsharded": (B, C), "(2, 1)": (B // 2, C),
             "(1, 2)": (B, C // 2)}
    res = {name: {} for name in PATH_KERNELS}
    for label, (b, c) in cases.items():
        seds = state.seds[0][:b, :, :c].contiguous()
        m, origins = state.morphs[0][:b], state.origins[0][:b]
        on = state.comp_active[0][:b]
        shape = f"B={b} K={m.shape[1]} C={c} {H}x{W} box={m.shape[-1]}"
        res["scene_assembly"][label] = dict(
            **scene_check(seds, m, origins, on, (c, H, W), P), shape=shape)
        res["grad_gather"][label] = dict(
            **grad_check(strided_gradient(b, c, H, W, config.fft_shape,
                                          dev), seds, m, origins, P),
            shape=shape)
    b = B // 2
    m = (state.morphs[0][:b] * data.box_masks[0][:b]).contiguous()
    idx = kn.candidate_index(m, config.fit_center_radius)
    wt, kt, n_iter = data.mono_weights[0], data.mono_keep[0], \
        config.mono_n_iters[0]

    def k1(f):
        return f(m, idx, wt, kt, n_iter, 0.0, tol=0.0)

    passes = mono_passes_run(m, idx, wt, kt, n_iter, 0.0)
    res["monotonic_prox"]["(2, 1)"] = dict(
        **bound(2 * nbytes(m) + nbytes(idx) + taps_bytes(idx, wt, kt),
                mono_ops(passes, idx, wt)),
        mean_passes=float(passes.double().mean()),
        max_abs_err=float((k1(kn.monotonic_prox)
                           - k1(kn.monotonic_prox_plain)).abs().max()),
        limit=0.0, ms=device_ms(lambda: k1(kn.monotonic_prox),
                                "mono_kernel"),
        plain_ms=time_ms(lambda: k1(kn.monotonic_prox_plain), 3),
        shape=f"B={b} K={m.shape[1]} box={m.shape[-1]} n_iter={n_iter}")
    for name, by_shape in res.items():
        for label, r in by_shape.items():
            err = r["g_morph_err"] if name == "grad_gather" \
                else r["max_abs_err"]
            if err != 0.0:
                raise AssertionError(f"{name} at the sharded shape {label} "
                                     f"differs from its plain version by "
                                     f"{err}")
            log(f"kernel {name} at the sharded shape {label}: max_abs_err "
                f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms device, "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                f"ms by {r['bound_by']} [{r['shape']}] on {card}")
    return res


def _sh_distance(got, ref):
    """How far ``got`` is from ``ref`` (numpy): the largest absolute
    difference and the elements beyond the JAX test's limits."""
    diff = np.abs(got - ref)
    beyond = diff > SH_STATE_ATOL + SH_STATE_RTOL * np.abs(ref)
    return dict(max_abs=float(diff.max()), beyond_limits=int(beyond.sum()))


def sharded_two_ranks(dev, card):
    """(b) Two ranks on the one card over gloo, meshes (1, 2) with the
    channels split and (2, 1), each against the unsharded card fit of the
    same batch: losses to SH_LOSS_RTOL; SEDs and morphologies to the JAX
    test's limits (SH_STATE_RTOL, SH_STATE_ATOL) or, where the unsharded
    fit itself moves past them on a 1e-7 change of its images (the
    batch's conditioning: a threshold or centre decision that roundoff
    flips), to SH_WITNESS_FACTOR times that move.  Returns (per mesh and
    rank the launch counts, kernel checks, summary)."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from scarlet_tpu_torch import parallel

    config, data, state = sharded_batch(dev)
    checks = sharded_kernel_checks(dev, card, config, data, state)
    parallel.fit_batch(state, data, config, SH_WARM)
    (ref, ref_losses), ref_ms = _sh_timed(
        lambda: parallel.fit_batch(state, data, config, SH_ITERS), SH_ITERS)
    noise = np.random.default_rng(SEED).standard_normal(
        tuple(data.images.shape)).astype(np.float32)
    moved = data._replace(images=data.images * (
        1 + SH_PERTURB * torch.from_numpy(noise).to(dev)))
    witness, witness_losses = parallel.fit_batch(state, moved, config,
                                                 SH_ITERS)
    host = tuple(_sh_to_cpu(x) for x in (config, data, state))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(host, os.path.join(tmp, "batch.pt"))
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(2, tmp), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(2)]
    ref_losses = ref_losses.cpu().numpy()
    refs = {key: getattr(ref, key)[0].cpu().numpy()
            for key in ("seds", "morphs")}
    spread = {key: _sh_distance(getattr(witness, key)[0].cpu().numpy(),
                                refs[key]) for key in refs}
    spread["max_rel_loss"] = float(
        np.abs(witness_losses.cpu().numpy() - ref_losses).max()
        / np.abs(ref_losses).max())
    summary = dict(blends=SH_N, bands=SH_BANDS, iterations=SH_ITERS,
                   unsharded_ms_per_iteration=ref_ms, spawn_s=spawn_s,
                   unsharded_spread_on_perturbed_images=spread, meshes={})
    log(f"sharded (b): the unsharded card fit on images x (1 + "
        f"{SH_PERTURB} N(0, 1)) moves by {spread} over {SH_ITERS} "
        f"iterations on {card}")
    launches = {}
    for shape, shard_bands in SH_MESHES:
        per_rank = [r[shape] for r in ranks]
        dist_ = []
        for rank, r in enumerate(per_rank):
            np.testing.assert_allclose(r["losses"].numpy(), ref_losses,
                                       rtol=SH_LOSS_RTOL)
            d = {key: _sh_distance(r[key].numpy(), refs[key])
                 for key in refs}
            for key, dk in d.items():
                if dk["beyond_limits"] and dk["max_abs"] > \
                        SH_WITNESS_FACTOR * spread[key]["max_abs"]:
                    raise AssertionError(
                        f"mesh {shape} rank {rank}: {key} off the "
                        f"unsharded fit by {dk}, beyond the limits and "
                        f"beyond {SH_WITNESS_FACTOR} x the unsharded fit's "
                        f"own move {spread[key]}")
            dist_.append(d)
            for name in PATH_KERNELS:
                if r["launches"][name] <= 0:
                    raise AssertionError(f"{name} was not launched on rank "
                                         f"{rank} of mesh {shape}")
        rel = max(float(np.abs(r["losses"].numpy() - ref_losses).max()
                        / np.abs(ref_losses).max()) for r in per_rank)
        label = str(shape)
        launches[label] = [r["launches"] for r in per_rank]
        summary["meshes"][label] = dict(
            shard_bands=shard_bands,
            ms_per_iteration=[r["ms_per_iteration"] for r in per_rank],
            all_reduces_per_iteration=[r["all_reduces_per_iteration"]
                                       for r in per_rank],
            launches=launches[label], max_rel_loss=rel,
            distance=dist_, devices=[r["device"] for r in per_rank])
        log(f"sharded (b), mesh {shape} (shard_bands={shard_bands}), two "
            f"ranks on one card over gloo, {SH_ITERS} iterations of "
            f"{SH_N} x {SH_BANDS}-band blends: max rel loss {rel:.3g} "
            f"(limit {SH_LOSS_RTOL}), seds and morphs off the unsharded fit "
            f"by {dist_}; ms per iteration "
            f"{[round(r['ms_per_iteration'], 3) for r in per_rank]} "
            f"against the unsharded {ref_ms:.3f}; all-reduces per "
            f"iteration {[r['all_reduces_per_iteration'] for r in per_rank]}"
            f"; launches per rank {launches[label]} on {card}")
    return launches, checks, summary


def _sh_to_cpu(x):
    """A config, BlendData or BlendState with its tensors on the host."""
    from scarlet_tpu_torch.lite import engine

    if dataclasses.is_dataclass(x):
        return x
    return engine.map_tree(lambda t: t.cpu(), x)


def sharded_phase(dev, card, setup):
    """The sharded fit: (a) then (b).  Returns (one-rank counts, two-rank
    launches per mesh and rank, kernel checks, summary)."""
    t_phase = time.perf_counter()
    one_counts, one = sharded_one_rank(card, setup)
    two_launches, checks, two = sharded_two_ranks(dev, card)
    return one_counts, two_launches, checks, dict(
        one_rank=one, two_ranks=two,
        phase_s=time.perf_counter() - t_phase)


# the production host paths: the multiprocess pipeline (the host path's
# blends as blobs), the deblend CLI as a subprocess on generated npz files
# and the regression harness on a generated set 4
HP_WORKERS = 8
# timed pipeline runs after the warm-up: the first also pays this
# process' first set-up at the full batch (seconds of its setup_s), the
# other NATIVE_RUNS are steady
HP_RUNS = 4
HP_CLI_FILES, HP_CLI_NOCAT, HP_CLI_NOVAR = 64, 8, 8
HP_CLI_CPU_FILES = 8
HP_DETECT_ITERS = 10
HP_SET, HP_MAIN_BLENDS = 4, 4
HP_PIPELINE_RTOL = 1e-6  # pipeline against the same fit in process
# the CLI's card against --cpu: the card's own move on perturbed copies
HP_PERTURB, HP_WITNESS_DRAWS, HP_WITNESS_FACTOR = 1e-7, 8, 3.0
# stream against lite logL per blend on the JAX test's blends, the first
# HP_STREAM_LITE_BLENDS of set 4 (tests/test_testing_harness.py:16-19,
# 166); over the whole set only logged: the JAX package's own stream
# parts from its lite fit past the limit on set 4's blends 36 (2.25%,
# 10 against 24 iterations) and 43 (110%, stopped at iteration 8) on
# the CPU (tests/stream_lite_witness.py)
HP_STREAM_LITE, HP_STREAM_LITE_BLENDS = 0.02, 4
HP_CENTROID_PX = 2.0     # tests/test_cli.py:72-77


def hp_record_build(blob, record_dir):
    """``build_lite_blend`` in a pipeline worker, after writing what the
    worker sees of CUDA and its torch threads to ``record_dir``."""
    import uuid

    import torch
    from scarlet_tpu_torch import parallel

    with open(os.path.join(record_dir, f"{uuid.uuid4().hex}.json"),
              "w") as f:
        json.dump({"pid": os.getpid(),
                   "CUDA_VISIBLE_DEVICES":
                       os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "device_count": torch.cuda.device_count(),
                   "threads": torch.get_num_threads()}, f)
    return parallel.build_lite_blend(blob)


def _hp_read_records(record_dir):
    out = []
    for name in sorted(os.listdir(record_dir)):
        with open(os.path.join(record_dir, name)) as f:
            out.append(json.load(f))
    return out


def _hp_blobs():
    """The host path's generated blends (``default_rng(SEED)``) as
    pipeline blobs, with their truth catalogs."""
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(SEED)
    raw = [generate_blend(rng) for _ in range(N_BLENDS)]
    return [{"images": d["images"], "variance": d["variance"],
             "psfs": d["psfs"],
             "centers": [(float(r["y"]), float(r["x"]))
                         for r in d["catalog"]]} for d in raw]


def hp_kernel_checks(dev, card, label, config, data, state):
    """K1, K3 and K4 against their plain versions on a path's packed fit
    inputs: K1 at the path's exit tolerance, K3 and K4 bit for bit (K4's
    g_sed to GRAD_SED_RTOL)."""
    from scarlet_tpu_torch.ops import kernels as kn

    C, H, W = config.scene_shape
    P = config.pad
    seds, m = state.seds[0], state.morphs[0]
    origins, on = state.origins[0], state.comp_active[0]
    B, K = on.shape
    shape = f"B={B} K={K} C={C} {H}x{W} box={m.shape[-1]}"
    timed_by = {}

    def timer(fn, key, reps=20):
        """The profiler's device time, or CUDA events where it records no
        launch of the kernel (it can miss short kernels late in a long
        run: ROADMAP Queue 3)."""
        try:
            ms = device_ms(fn, key, reps)
            timed_by.setdefault(key, "profiler")
        except AssertionError as exc:
            log(f"{exc}: {key} timed with CUDA events")
            ms = time_ms(fn, reps)
            timed_by[key] = "CUDA events"
        return ms

    res = {"scene_assembly": dict(
        **scene_check(seds, m, origins, on, (C, H, W), P, timer=timer),
        shape=shape),
        "grad_gather": dict(
            **grad_check(strided_gradient(B, C, H, W, config.fft_shape, dev),
                         seds, m, origins, P, timer=timer), shape=shape)}
    mm = (m * data.box_masks[0]).contiguous()
    idx = kn.candidate_index(mm, config.fit_center_radius)
    wt, kt, n_iter = data.mono_weights[0], data.mono_keep[0], \
        config.mono_n_iters[0]
    tol = float(config.mono_tol)

    def k1(f):
        return f(mm, idx, wt, kt, n_iter, 0.0, tol=tol)

    passes = mono_passes_run(mm, idx, wt, kt, n_iter, tol)
    res["monotonic_prox"] = dict(
        **bound(2 * nbytes(mm) + nbytes(idx) + taps_bytes(idx, wt, kt),
                mono_ops(passes, idx, wt)),
        mean_passes=float(passes.double().mean()),
        max_abs_err=float((k1(kn.monotonic_prox)
                           - k1(kn.monotonic_prox_plain)).abs().max()),
        limit=0.0, ms=timer(lambda: k1(kn.monotonic_prox), "mono_kernel"),
        plain_ms=time_ms(lambda: k1(kn.monotonic_prox_plain), 3),
        shape=f"{shape} n_iter={n_iter} tol={tol}")
    for name, key in (("scene_assembly", "scene_kernel"),
                      ("grad_gather", "grad_kernel"),
                      ("monotonic_prox", "mono_kernel")):
        res[name]["timed_by"] = timed_by[key]
    for name, r in res.items():
        err = r["g_morph_err"] if name == "grad_gather" \
            else r["max_abs_err"]
        if err != 0.0:
            raise AssertionError(f"{name} at the {label} shape differs from "
                                 f"its plain version by {err}")
        log(f"kernel {name} at the {label} shape: max_abs_err "
            f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms "
            f"({r['timed_by']}), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} [{r['shape']}] on {card}")
    return res


def hp_pipeline(dev, card, setup, init_s):
    """(a) ``BlendPipeline`` with min(HP_WORKERS, cores) workers on the
    host path's 128 blobs: a warm-up run, the counted run and
    HP_RUNS - 1 more.
    Records held to the same fit of ``pack_blends``'s batch in process;
    every worker sees no card.  Returns (counts, summary)."""
    import tempfile

    from scarlet_tpu_torch import parallel
    from scarlet_tpu_torch.ops import kernels as kn

    n_workers = min(HP_WORKERS, os.cpu_count())
    blobs = _hp_blobs()
    summary = dict(workers=n_workers, blends=len(blobs),
                   in_process_init_s_per_128=init_s * 128 / N_BLENDS)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with parallel.BlendPipeline(n_workers, fit_device=dev) as pipe:
            pipe.run(blobs[:n_workers], hp_record_build,
                     build_kwargs={"record_dir": tmp}, max_iter=2)
            warm_s = time.perf_counter() - t0
            runs = []
            for i in range(HP_RUNS):
                kn.reset_launch_counts()
                t1 = time.perf_counter()
                records = pipe.run(blobs, hp_record_build,
                                   build_kwargs={"record_dir": tmp},
                                   max_iter=MAX_ITER,
                                   check_every=CHECK_EVERY)
                wall = time.perf_counter() - t1
                if i == 0:
                    counts = kn.launch_counts()
                runs.append(dict(pipe.last_timings, wall_s=wall,
                                 blends_per_min=len(blobs) / wall * 60.0))
        seen = _hp_read_records(tmp)
    summary.update(spawn_and_warm_up_s=warm_s, runs=runs)
    if not seen or any(s["device_count"] != 0 or
                       s["CUDA_VISIBLE_DEVICES"] != "" for s in seen):
        raise AssertionError(f"a pipeline worker saw the card: {seen[:4]}")
    summary["worker_threads"] = sorted({s["threads"] for s in seen})
    summary["workers_seen"] = len({s["pid"] for s in seen})

    config, data, state = setup
    out, losses = parallel.fit_batch_device_converged(
        state, data, config, MAX_ITER, check_every=CHECK_EVERY)
    its = out.it.cpu().numpy()
    losses = losses.cpu().numpy()
    ref = losses[its - 1, np.arange(len(its))]
    got_its = np.array([r["iterations"] for r in records])
    got = np.array([r["logL"] for r in records])
    rel = np.abs(got - ref) / np.abs(ref)
    summary.update(max_rel_logL=float(rel.max()),
                   bitwise=bool(np.array_equal(got, ref.astype(np.float64))),
                   median_iterations=float(np.median(got_its)),
                   launches={k: int(counts[k]) for k in PATH_KERNELS})
    if not (np.array_equal(got_its, its) and rel.max() <= HP_PIPELINE_RTOL):
        raise AssertionError(
            f"pipeline records differ from the in-process fit: iterations "
            f"equal {np.array_equal(got_its, its)}, max rel logL "
            f"{rel.max():.3g} (limit {HP_PIPELINE_RTOL})")
    worse = [(r["init logL"], r["logL"]) for r in records
             if not r["logL"] > r["init logL"]]
    if worse:
        raise AssertionError(f"pipeline logL did not improve: {worse}")
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the pipeline")
    last = runs[-1]
    phases = [{k: r[k] for k in ("init_s", "setup_s", "fit_s", "writeback_s")}
              for r in runs]
    log(f"pipeline (a): BlendPipeline, {n_workers} workers (torch threads "
        f"{summary['worker_threads']}, no card in any of "
        f"{summary['workers_seen']}), {len(blobs)} blends: last_timings "
        f"{phases}"
        f", {last['blends_per_min']:.1f} blends/min "
        f"({runs[0]['blends_per_min']:.1f} in the counted run); host init "
        f"{last['init_s']:.3f} s per 128 in workers against the in-process "
        f"{summary['in_process_init_s_per_128']:.2f} s of this run; "
        f"spawn and warm-up "
        f"{warm_s:.1f} s; records against the in-process fit: iterations "
        f"equal, max rel logL {rel.max():.3g} (bit for bit "
        f"{summary['bitwise']}); launches {summary['launches']} on {card}")
    return counts, summary


def _hp_cli_files(tmp):
    """HP_CLI_FILES generated npz files (``default_rng(SEED)``): the first
    HP_CLI_NOCAT without a catalog, the next HP_CLI_NOVAR without a
    variance plane.  Returns (paths, truth catalogs (y, x))."""
    from scarlet_tpu_torch.testing import generate_blend

    rng = np.random.default_rng(SEED)
    paths, truths = [], []
    for i in range(HP_CLI_FILES):
        d = generate_blend(rng)
        keys = dict(images=d["images"], psfs=d["psfs"])
        if i >= HP_CLI_NOCAT:
            keys["catalog"] = d["catalog"]
        if not HP_CLI_NOCAT <= i < HP_CLI_NOCAT + HP_CLI_NOVAR:
            keys["variance"] = d["variance"]
        path = os.path.join(tmp, f"blend_{i:03d}.npz")
        np.savez_compressed(path, **keys)
        paths.append(path)
        truths.append(np.stack([d["catalog"]["y"], d["catalog"]["x"]], 1))
    return paths, truths


def _hp_cli(files, out, *extra):
    """``python -m scarlet_tpu_torch deblend`` in a subprocess (its
    ``main``, then the kernels' launch counts of that process on a line of
    their own): (output dict, launch counts, wall s)."""
    code = ("import json, sys; from scarlet_tpu_torch.__main__ import main; "
            "from scarlet_tpu_torch.ops import kernels; "
            "rc = main(sys.argv[1:]); "
            "print('COUNTS ' + json.dumps(kernels.launch_counts())); "
            "sys.exit(rc)")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code, "deblend", *files,
                          "--out", out, *extra], capture_output=True,
                         text=True, timeout=600, env=env, cwd=root)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the deblend CLI failed ({res.returncode}): "
                             f"{res.stderr[-3000:]}")
    counts = json.loads([line for line in res.stdout.splitlines()
                         if line.startswith("COUNTS ")][-1][7:])
    with open(out) as f:
        return json.load(f), counts, wall


def _hp_sorted(cen):
    cen = np.asarray(cen, float)
    return cen[np.lexsort(cen.T)]


def hp_cli(dev, card):
    """(b) The deblend CLI as a subprocess on the card: HP_CLI_FILES npz
    files; ``--detect device`` against ``--detect host``; HP_CLI_CPU_FILES
    of them with ``--cpu``; K1, K3 and K4 at the CLI's fit shapes (its
    ``stream_setup`` in this process).  Returns (counts, checks,
    summary)."""
    import tempfile

    import torch
    from scarlet_tpu_torch.__main__ import _load_blend
    from scarlet_tpu_torch.parallel import stream

    with tempfile.TemporaryDirectory() as tmp:
        paths, truths = _hp_cli_files(tmp)
        res, counts, wall = _hp_cli(paths, os.path.join(tmp, "out.json"))
        recs = res["records"]
        logl = np.array([r["logL"] for r in recs])
        init = np.array([r["init_logL"] for r in recs])
        if not np.all(np.isfinite(logl)) or not all(
                np.all(np.isfinite(np.asarray(r["flux"], float)))
                for r in recs):
            raise AssertionError("non-finite CLI records")
        worse = float(np.mean(logl <= init))
        errs = np.concatenate([
            np.linalg.norm(np.asarray(r["centroid"], float) - t, axis=1)
            for r, t in zip(recs[HP_CLI_NOCAT:], truths[HP_CLI_NOCAT:])])
        med_err = float(np.nanmedian(errs))
        if worse > MAX_WORSE or not med_err < HP_CENTROID_PX:
            raise AssertionError(f"CLI records: logL not improved for "
                                 f"{worse:.3f} of the blends, median "
                                 f"centroid error {med_err:.3f} px")
        for name in PATH_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched by the CLI")
        det = {mode: _hp_cli(paths, os.path.join(tmp, f"{mode}.json"),
                             "--detect", mode, "--max-iter",
                             str(HP_DETECT_ITERS))
               for mode in ("host", "device")}
        det_diff = 0.0
        for rh, rd in zip(det["host"][0]["records"],
                          det["device"][0]["records"]):
            if rh["n_sources"] != rd["n_sources"]:
                raise AssertionError(f"{rh['file']}: host detection "
                                     f"{rh['n_sources']} sources, device "
                                     f"{rd['n_sources']}")
            det_diff = max(det_diff, float(np.abs(
                _hp_sorted(rh["centroid"]) - _hp_sorted(rd["centroid"])
            ).max()))
        if not det_diff <= 0.1:
            raise AssertionError(f"device and host detection centroids "
                                 f"differ by {det_diff} px")
        # card against --cpu, held to CPU_RTOL, or where the card's own
        # runs on HP_WITNESS_DRAWS copies of the images times
        # (1 + HP_PERTURB N(0, 1)) move a blend's iterations or logL (its
        # conditioning: a roundoff flip of the convergence test), to
        # HP_WITNESS_FACTOR times that move (the object tree's rule)
        sel = paths[HP_CLI_NOCAT + HP_CLI_NOVAR:][:HP_CLI_CPU_FILES]
        moved = []
        rng = np.random.default_rng(SEED)
        for draw in range(HP_WITNESS_DRAWS):
            for p in sel:
                d = dict(np.load(p, allow_pickle=True))
                noise = rng.standard_normal(d["images"].shape)
                d["images"] = (d["images"] * (1 + HP_PERTURB * noise)
                               ).astype(np.float32)
                moved.append(p.replace(".npz", f"_moved{draw}.npz"))
                np.savez(moved[-1], **d)
        runs = {name: _hp_cli(files, os.path.join(tmp, f"{name}.json"),
                              *extra)[0]["records"]
                for name, files, extra in (("card", sel, ()),
                                           ("cpu", sel, ("--cpu",)),
                                           ("card_moved", moved, ()))}
        its = {k: np.array([r["iterations"] for r in v]).reshape(-1, len(sel))
               for k, v in runs.items()}
        ll = {k: np.array([r["logL"] for r in v]).reshape(-1, len(sel))
              for k, v in runs.items()}
        cpu_rel = np.abs(ll["cpu"][0] - ll["card"][0]) / np.abs(ll["card"][0])
        own = (np.abs(ll["card_moved"] - ll["card"]) / np.abs(ll["card"])
               ).max(axis=0)
        own_its = (its["card_moved"] != its["card"]).any(axis=0)
        allowed = np.maximum(CPU_RTOL, HP_WITNESS_FACTOR * own)
        bad = ((its["card"][0] != its["cpu"][0]) & ~own_its) \
            | (cpu_rel > allowed)
        h_its = its["cpu"][0].tolist()
        if bad.any():
            raise AssertionError(
                f"CLI card against --cpu: iterations "
                f"{its['card'][0].tolist()} vs {h_its} (the card's own on "
                f"moved images {its['card_moved'].tolist()}), rel logL "
                f"{cpu_rel} against the allowed {allowed}")
        cpu_rel = dict(max=float(cpu_rel.max()), per_file=cpu_rel.tolist(),
                       card_own_move=own.tolist(),
                       card_iterations=its["card"][0].tolist(),
                       card_moved_iterations=its["card_moved"].tolist())

        # the CLI's fit inputs, built here for the kernel checks
        blends = [_load_blend(p) for p in paths]
    K = max(len(b[3]) for b in blends)
    carr = np.zeros((len(blends), K, 2), np.int32)
    cact = np.zeros((len(blends), K), bool)
    for i, b in enumerate(blends):
        carr[i, :len(b[3])] = b[3]
        cact[i, :len(b[3])] = True
    _, H, W = blends[0][0].shape
    cap = max(H, W) + 1
    config, data, state, _ = stream.stream_setup(
        *(np.stack([b[j] for b in blends]) for j in range(3)), carr,
        model_psf(), center_active=cact, box_size=cap - (cap % 2 == 0),
        n_slots=2 * K, device=dev)
    checks = hp_kernel_checks(dev, card, "CLI", config, data, state)
    del data, state
    torch.cuda.empty_cache()
    summary = dict(files=len(paths), wall_s=wall,
                   blends_per_min=res["blends_per_min"],
                   command_wall_s=res["wall_s"], worse_share=worse,
                   median_centroid_err_px=med_err,
                   median_iterations=float(np.median(
                       [r["iterations"] for r in recs])),
                   detect_centroid_max_diff_px=det_diff,
                   detect_blends_per_min={m: det[m][0]["blends_per_min"]
                                          for m in det},
                   cpu_files=len(sel), cpu_iterations=h_its,
                   cpu_vs_card=cpu_rel,
                   launches={k: int(counts[k]) for k in PATH_KERNELS})
    log(f"CLI (b): python -m scarlet_tpu_torch deblend on {len(paths)} npz "
        f"files ({HP_CLI_NOCAT} without a catalog, {HP_CLI_NOVAR} without "
        f"variance), on the card: {res['blends_per_min']} blends/min by its "
        f"own clock ({res['wall_s']} s; {wall:.1f} s with the process' "
        f"start), median iterations {summary['median_iterations']}, logL "
        f"not improved for {worse:.3f}, median centroid error "
        f"{med_err:.3f} px; --detect device vs host: centroids within "
        f"{det_diff:.3g} px ({summary['detect_blends_per_min']} blends/min "
        f"at {HP_DETECT_ITERS} iterations); {len(sel)} files with --cpu: "
        f"iterations {h_its} against the card's "
        f"{cpu_rel['card_iterations']}, rel logL {cpu_rel['per_file']} "
        f"(limit {CPU_RTOL}, or {HP_WITNESS_FACTOR} x the card's own move "
        f"on {HP_WITNESS_DRAWS} copies of the images x (1 + {HP_PERTURB} "
        f"N(0, 1)): {cpu_rel['card_own_move']}, iterations "
        f"{cpu_rel['card_moved_iterations']}); "
        f"launches {summary['launches']} on {card}")
    return counts, checks, summary


def hp_harness(dev, card):
    """(c) The regression harness on the card on a generated set HP_SET
    (50 blends) in a temporary root: "stream" and "lite" on all blends,
    "main" on HP_MAIN_BLENDS, each with the kernel counts zeroed just
    before it; stream against lite logL per blend; detection on the
    device against the host.  Returns (counts per pipeline, summary)."""
    import tempfile

    from scarlet_tpu_torch import testing
    from scarlet_tpu_torch.ops import kernels as kn

    counts, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = testing.bundled_blends(HP_SET, root=tmp)
        results = {}
        for pipe in ("stream", "lite", "main"):
            sel = paths[:HP_MAIN_BLENDS] if pipe == "main" else paths
            kn.reset_launch_counts()
            t0 = time.perf_counter()
            recs = testing.deblend_and_measure(
                set_ids=(HP_SET,), paths=sel, save=False, pipeline=pipe,
                device=dev)[HP_SET]
            wall = time.perf_counter() - t0
            counts[pipe] = kn.launch_counts()
            results[pipe] = recs
            logl = [r["logL"] for r in recs]
            if not all(np.isfinite(logl)) or not all(
                    r["logL"] > r["init logL"] for r in recs):
                raise AssertionError(f"harness {pipe}: logL not finite or "
                                     f"not improved")
            summary[pipe] = dict(
                blends=len(recs), wall_s=wall,
                median_logL=float(np.median(logl)),
                median_iterations=float(np.median(
                    [r["iterations"] for r in recs])),
                launches={k: int(counts[pipe][k]) for k in PATH_KERNELS})
        for pipe in ("stream", "lite"):
            for name in PATH_KERNELS:
                if counts[pipe][name] <= 0:
                    raise AssertionError(f"{name} was not launched by the "
                                         f"harness's {pipe} pipeline")
        if counts["main"]["monotonic_prox"] <= 0:
            raise AssertionError("K1 was not launched by the harness's main "
                                 "pipeline")
        ll = np.array([r["logL"] for r in results["lite"]])
        ls = np.array([r["logL"] for r in results["stream"]])
        rel = np.abs(ls - ll) / np.abs(ll)
        stream_lite = float(rel[:HP_STREAM_LITE_BLENDS].max())
        beyond = [dict(blend=int(i), rel=float(rel[i]),
                       iterations={p: results[p][i]["iterations"]
                                   for p in ("stream", "lite")},
                       logL={p: results[p][i]["logL"]
                             for p in ("stream", "lite")})
                  for i in np.flatnonzero(rel >= HP_STREAM_LITE)]
        if not stream_lite < HP_STREAM_LITE:
            raise AssertionError(f"harness stream against lite logL on the "
                                 f"first {HP_STREAM_LITE_BLENDS} blends: "
                                 f"{stream_lite:.3g}")
        det = {on: testing.api.detection_quality(
            set_ids=(HP_SET,), paths=paths, host=not on, device=dev)
            [HP_SET] for on in (True, False)}
        if det[True]["completeness"] != det[False]["completeness"]:
            raise AssertionError(
                f"detection completeness device {det[True]['completeness']}"
                f" vs host {det[False]['completeness']}")
    summary.update(stream_vs_lite_max_rel_logL=stream_lite,
                   stream_vs_lite_all=dict(median=float(np.median(rel)),
                                           beyond_limit=beyond),
                   detection_completeness=det[True]["completeness"],
                   detection_false_rate=det[True]["false_rate"])
    log(f"harness (c): generated set {HP_SET} on the card: "
        + "; ".join(f"{p} {v['blends']} blends {v['wall_s']:.2f} s, median "
                    f"logL {v['median_logL']:.6g}, median iterations "
                    f"{v['median_iterations']}, launches {v['launches']}"
                    for p, v in ((p, summary[p])
                                 for p in ("stream", "lite", "main")))
        + f"; stream vs lite max rel logL {stream_lite:.3g} on the first "
        f"{HP_STREAM_LITE_BLENDS} blends (limit {HP_STREAM_LITE}), over all "
        f"{len(rel)} median {np.median(rel):.3g}, beyond the limit "
        f"{beyond}; detection completeness "
        f"{det[True]['completeness']:.4f} on the device = host on {card}")
    return counts, summary


def host_paths_phase(dev, card, setup, init_s):
    """The production host paths: (a) the pipeline, (b) the CLI, (c) the
    harness, each with the kernel counts zeroed just before its run, and
    K1, K3 and K4 against their plain versions at the pipeline's and the
    CLI's fit shapes.  Returns (counts per path, checks, summary)."""
    t_phase = time.perf_counter()
    pipe_counts, pipe = hp_pipeline(dev, card, setup, init_s)
    checks = {"pipeline": hp_kernel_checks(dev, card, "pipeline", *setup)}
    cli_counts, checks["CLI"], cli = hp_cli(dev, card)
    harness_counts, harness = hp_harness(dev, card)
    counts = dict(pipeline=pipe_counts, cli=cli_counts,
                  harness=harness_counts)
    return counts, checks, dict(pipeline=pipe, cli=cli, harness=harness,
                                phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# 14. the tutorial examples (scarlet_tpu_torch.examples) on their stand-ins
# ---------------------------------------------------------------------------
# the examples whose fits run the lite engine or the multi-resolution
# fitter, and so launch K3 and K4 besides K1
EX_K34 = ("multiscale_deblending", "stream_deblending", "batched_deblending",
          "multiresolution", "hsc_hst_multires")
# the JAX scripts' SCARLET_TPU_FAST depths (True) or their full depths
EX_FAST = False
# starlet_source's recipe with the host mask projection (the host C
# library's fills): the share of the fit's wall above which the projection
# binds the fit (ROADMAP Queue 1 item 6 asked for the library above it)
EX_MASK_SHARE_LIMIT = 0.2


def ex_inputs():
    """Each example's input: the stand-in of its data file at the file's
    size (``testing.example_data``'s defaults), or the multiresolution
    example's own data."""
    from scarlet_tpu_torch.examples import multiresolution
    from scarlet_tpu_torch.testing import example_data as ed

    hsc = ed.hsc_cosmos_35()
    return {"quickstart": hsc, "display_tutorial": hsc,
            "point_source": ed.psf_unmatched_sim(),
            "starlet_source": hsc, "lsbg_wavelet_model": ed.lsbg(),
            "multiscale_deblending": ed.testdata_3_0(),
            "stream_deblending": hsc, "batched_deblending": hsc,
            "multiresolution": multiresolution.load(),
            "hsc_hst_multires": ed.test_resampling()}


def _copy(x):
    """A copy of a tensor argument with its strides (the gradient K4
    reads is a strided crop); anything else as it is."""
    import torch

    if not isinstance(x, torch.Tensor):
        return x
    out = torch.empty_strided(tuple(x.shape), x.stride(), dtype=x.dtype,
                              device=x.device)
    return out.copy_(x.detach())


class RecordKernel:
    """Stands in for the K3 or K4 wrapper while the examples run, as
    :class:`RecordK1` does for K1: keeps a copy of the first input of each
    new ``key(*args)`` in ``store`` and calls the wrapper, whose counter
    is this object's while it stands in."""

    launches = _counter("launches")

    def __init__(self, orig, store, key):
        self.orig, self.store, self.key = orig, store, key

    def __call__(self, *args):
        key = self.key(*args)
        if key not in self.store:
            self.store[key] = tuple(_copy(a) for a in args)
        return self.orig(*args)


def _scene_key(seds, morphs, origins, on, scene_shape, pad):
    return (tuple(seds.shape), tuple(morphs.shape), tuple(scene_shape),
            int(pad))


def _grad_key(grad, seds, morphs, origins, pad):
    return (tuple(grad.shape), tuple(grad.stride()), tuple(seds.shape),
            tuple(morphs.shape), int(pad))


def _overhang(origins, box, hw):
    """The pad that holds every box of ``origins`` inside an (H, W) scene."""
    oy, ox = origins[..., 0], origins[..., 1]
    return max(0, -int(oy.min()), -int(ox.min()),
               int(oy.max()) + box[0] - hw[0], int(ox.max()) + box[1] - hw[1])


def _event_timer(fn, key, reps=20):
    """CUDA events for the examples' shape checks (bit for bit is what
    they hold; the kernels' times at the paths' shapes are the earlier
    phases')."""
    return time_ms(fn, reps)


def ex_kernel_checks(stores, name, card):
    """K1, K3 and K4 against their plain versions on the first input of
    every shape the example ``name`` launched that no example before it
    in the phase launched: K1 and K3 bit for bit, K4's g_morph bit for
    bit and its g_sed to GRAD_SED_RTOL, with the existing helpers
    (:func:`sl_kernel_checks`, :func:`scene_check`, :func:`grad_check`).
    The inputs are dropped once checked; their keys stay, so the next
    example records only shapes new to the phase."""
    new = {k: {key: v for key, v in s.items() if v is not None}
           for k, s in stores.items()}
    out = {"monotonic_prox": sl_kernel_checks(
        new["monotonic_prox"], card, f"the {name} example's shapes")
        if new["monotonic_prox"] else []}
    out["scene_assembly"] = []
    for key, (seds, m, origins, on, scene_shape, P) in new[
            "scene_assembly"].items():
        r = scene_check(seds, m, origins, on, scene_shape, P,
                        timer=_event_timer)
        if r["max_abs_err"] != 0.0:
            raise AssertionError(f"scene_assembly at {key} ({name}) differs "
                                 f"from its plain version by "
                                 f"{r['max_abs_err']}")
        out["scene_assembly"].append(dict(r, shape=str(key)))
        log(f"kernel scene_assembly at the {name} example's shape {key}: "
            f"bit for bit, kernel {r['ms']:.4f} ms (CUDA events), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, on {card}")
    out["grad_gather"] = []
    for key, (grad, seds, m, origins, pad) in new["grad_gather"].items():
        if pad != 0:
            raise AssertionError(f"grad_gather at {key} ({name}): the fits "
                                 f"pass the unpadded gradient, got pad {pad}")
        if grad.ndim == 3:
            grad, seds, m, origins = (x[None] for x in (grad, seds, m,
                                                        origins))
        P = _overhang(origins, m.shape[-2:], grad.shape[-2:])
        r = grad_check(grad, seds, m, origins, P, timer=_event_timer)
        if r["g_morph_err"] != 0.0:
            raise AssertionError(f"grad_gather at {key} ({name}): g_morph "
                                 f"differs from its plain version by "
                                 f"{r['g_morph_err']}")
        out["grad_gather"].append(dict(r, shape=str(key)))
        log(f"kernel grad_gather at the {name} example's shape {key}: "
            f"g_morph bit for bit, g_sed {r['g_sed_rel_err']:.3g} of sum "
            f"|g*morph| (limit {GRAD_SED_RTOL}), kernel {r['ms']:.4f} ms "
            f"(CUDA events), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, on {card}")
    for s in stores.values():
        for key in s:
            s[key] = None
    return out


def ex_display_devices(dev, data, sca, card):
    """The display of the card-fitted quickstart sources (the run's
    pickle: its parameters unpickle as host tensors, then go to the card)
    and of the same sources left on the CPU, each beside an observation of
    the stand-in on its device: the RGB panels that ``show_scene`` (two
    norms), ``show_sources`` and ``show_observation`` draw, from their
    panel functions (numpy: no matplotlib needed).  A panel of the models
    or the data is equal.  A panel of a render (rendered, residual) is
    equal but where a pixel saturates: the mapping's hue-preserving
    truncation divides the brightest channel by itself, which rounds to
    1 or to 1 - 2^-53 from the last bit of the float64 render (cuFFT and
    the CPU's FFT part by ~4e-16), so a saturated pixel shows 255 or 254;
    those pixels may differ by that one level.  Returns the panels
    compared and the saturated pixels that differ."""
    import pickle

    import torch
    from scarlet_tpu_torch import display, models

    def load(device):
        with open(sca, "rb") as f:
            sources = pickle.load(f)
        for src in sources:
            for p in src.parameters:
                p.to(device)
        return sources

    images = data["images"].astype(np.float32)
    weights = (1 / np.maximum(data["variance"], 1e-12)).astype(np.float32)
    centers = [(float(c["y"]), float(c["x"])) for c in data["catalog"]]

    def panels(sources, device):
        obs = models.Observation(
            images, list("grizy"), psf=models.ImagePSF(
                data["psfs"].astype(np.float32)), weights=weights,
            device=device).match(sources[0].frame)
        assert sources[0].get_model().device.type == torch.device(
            device).type
        norm = display.AsinhMapping(minimum=0, stretch=float(images.max())
                                    / 20, Q=10)
        scene = dict(show_observed=True, show_rendered=True,
                     show_residual=True)
        panels = display.scene_panels(sources, obs, **scene)
        panels += display.scene_panels(sources, obs, norm=norm, **scene)
        for _, row, _ in display.source_panels(
                sources, obs, norm=norm, show_rendered=True,
                show_observed=True):
            panels += row
        panels += display.observation_panels(obs, norm=norm, show_psf=True)
        return [(title, rgb) for title, rgb, _ in panels]

    on_card, on_cpu = panels(load(dev), dev), panels(load("cpu"), "cpu")
    if [t for t, _ in on_card] != [t for t, _ in on_cpu]:
        raise AssertionError("display: the card's and the CPU's figures "
                             "have different panels")
    saturated = 0
    for (title, a), (_, b) in zip(on_card, on_cpu):
        if a.shape != b.shape:
            raise AssertionError(f"display: panel {title!r} has shapes "
                                 f"{a.shape} and {b.shape}")
        diff = np.abs(a.astype(int) - b.astype(int))[..., :3].max(axis=-1)
        if not diff.any():
            continue
        rendered = "Rendered" in title or "Residual" in title
        at_top = (a[..., :3].max(-1) >= 254) & (b[..., :3].max(-1) >= 254)
        if not rendered or diff.max() > 1 or not at_top[diff > 0].all():
            raise AssertionError(
                f"display: panel {title!r} differs between the card and "
                f"the CPU in {int((diff > 0).sum())} pixels (by up to "
                f"{int(diff.max())} levels, saturated in "
                f"{int(at_top[diff > 0].sum())})")
        saturated += int((diff > 0).sum())
    log(f"display card vs CPU: {len(on_card)} panels of show_scene (default "
        f"and asinh norms), show_sources and show_observation on the "
        f"quickstart's card-fitted sources and the same sources on the CPU: "
        f"equal but {saturated} saturated pixels of the rendered and "
        f"residual panels, one level apart (255 against 254), on {card}")
    return dict(panels=len(on_card), saturated_pixels_one_level=saturated)


def ex_starlet_monotonic(dev, data, card):
    """starlet_source's recipe once more with the starlet source's
    ``monotonic=True`` (``MonotonicMaskConstraint``, the host mask
    projection): ``Blend.fit(80, e_rel=1e-4)`` on the card, and the host
    projection's calls and seconds (``mask_constraint_counts()``) against
    the fit's wall.  Returns the numbers."""
    import torch
    from scarlet_tpu_torch import detect, models
    from scarlet_tpu_torch.models import constraint as tcon

    images = data["images"].astype(np.float32)
    weights = (1 / np.maximum(data["variance"], 1e-12)).astype(np.float32)
    ch = list("grizy")
    frame = models.Frame(images.shape, channels=ch,
                         psf=models.GaussianPSF(sigma=0.8, boxsize=15))
    obs = models.Observation(images, ch, psf=models.ImagePSF(
        data["psfs"].astype(np.float32)), weights=weights,
        device=dev).match(frame)
    centers = [(float(c["y"]), float(c["x"])) for c in data["catalog"]]
    detect.get_peaks(images=images,
                     variance=data["variance"].astype(np.float32))
    sources = [models.StarletSource(frame, centers[0], obs,
                                    starlet_thresh=5e-3, monotonic=True)]
    sources += [models.SingleExtendedSource(frame, c, obs)
                for c in centers[1:]]
    blend = models.Blend(sources, obs)
    torch.cuda.synchronize()
    tcon.reset_mask_constraint_counts()
    t0 = time.perf_counter()
    it, logL = blend.fit(SL_MAX_ITER, e_rel=SL_E_REL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tcon.mask_constraint_counts()
    share = counts["seconds"] / wall
    out = dict(iterations=int(it), logL=float(logL), fit_s=wall,
               calls=counts["calls"], planes=counts["planes"],
               host_projection_s=counts["seconds"], share=share,
               over_limit=share > EX_MASK_SHARE_LIMIT)
    if counts["calls"] == 0 or not np.isfinite(logL):
        raise AssertionError(f"starlet monotonic=True: {out}")
    log(f"starlet_source with monotonic=True: {it} iterations, logL "
        f"{logL:.1f}, fit {wall:.3f} s; the host mask projection "
        f"(MonotonicMaskConstraint) {counts['calls']} calls, "
        f"{counts['planes']} planes, {counts['seconds']:.3f} s = "
        f"{100 * share:.2f}% of the fit's wall (the C library's fills; "
        f"{'over' if out['over_limit'] else 'under'} the "
        f"{100 * EX_MASK_SHARE_LIMIT:.0f}% at which the projection binds "
        f"the fit), on {card}")
    return out


def ex_figure_names(name):
    """The PNG file names the JAX package's script ``examples/<name>.py``
    writes (read as text from the checkout)."""
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    with open(path) as f:
        return set(re.findall(r"[\"'](\w+\.png)[\"']", f.read()))


def ex_check_figures(name, res, out_dir, figures):
    """Every figure's RGB panels were computed under the JAX script's PNG
    names ((H, W, 3), or 4 with a mask's alpha; only a likelihood figure
    has none), and the PNGs, written where matplotlib is installed, are
    those and non-empty.  Returns the PNGs' sizes."""
    want = ex_figure_names(name)
    if set(res["panels"]) != want:
        raise AssertionError(f"{name}: figures {sorted(res['panels'])}, the "
                             f"JAX script's {sorted(want)}")
    for f, shapes in res["panels"].items():
        if (not shapes and "likelihood" not in f) or any(
                len(sh) != 3 or sh[-1] not in (3, 4) for sh in shapes):
            raise AssertionError(f"{name}: figure {f} panels {shapes}")
    pngs = {f: os.path.getsize(os.path.join(out_dir, f))
            for f in res["files"] if f.endswith(".png")}
    if any(size == 0 for size in pngs.values()) or \
            set(pngs) != (want if figures else set()):
        raise AssertionError(f"{name}: figure files {pngs} (figures "
                             f"{figures})")
    return pngs


def _logL_improves(res, key, name):
    first, last = res[key]
    if not (np.isfinite(first) and np.isfinite(last) and last > first):
        raise AssertionError(f"{name}: {key} {first} -> {last} is not finite "
                             f"and improving")


def examples_phase(dev, card):
    """The ten examples' ``run()`` on the card, in the JAX package's
    order, on their stand-ins at the data files' sizes (EX_FAST: the
    depths), each with the kernel counts zeroed just before it and read
    just after; figures into a temporary directory.  Per example: wall
    seconds by step, iterations and logL, the PNGs and their sizes, K1,
    K3 and K4 launches; the checks; K1, K3 and K4 held to their plain
    versions on the first input of every shape new to the phase; the
    display of the quickstart's fitted sources on the card and on the
    CPU; the starlet recipe with the host mask projection.  Returns
    (launches per example, shape checks per example, summary)."""
    import importlib.util
    import tempfile

    import torch
    from scarlet_tpu_torch.examples import NAMES
    from scarlet_tpu_torch.ops import kernels as kn

    t_phase = time.perf_counter()
    # the examples draw their figures where matplotlib is installed;
    # without it they run every other step and write no PNG
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        log("examples: matplotlib is not installed here, so the examples "
            "compute every figure's RGB panels and draw none (no PNG); the "
            "figures are held to the JAX package's on the CPU "
            "(tests/test_torch_display.py, tests/test_torch_examples.py)")
    inputs = ex_inputs()
    stores = {name: {} for name in PATH_KERNELS}
    origs = {name: getattr(kn, name) for name in PATH_KERNELS}
    recorders = {
        "monotonic_prox": RecordK1(origs["monotonic_prox"],
                                   stores["monotonic_prox"]),
        "scene_assembly": RecordKernel(origs["scene_assembly"],
                                       stores["scene_assembly"], _scene_key),
        "grad_gather": RecordKernel(origs["grad_gather"],
                                    stores["grad_gather"], _grad_key)}
    counts, checks, summary = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in NAMES:
            module = importlib.import_module(
                f"scarlet_tpu_torch.examples.{name}")
            out_dir = os.path.join(tmp, name)
            torch.cuda.synchronize()
            kn.reset_launch_counts()
            for k, rec in recorders.items():
                setattr(kn, k, rec)
            t0 = time.perf_counter()
            try:
                res = module.run(inputs[name], out_dir=out_dir, fast=EX_FAST,
                                 device=dev)
            finally:
                for k, orig in origs.items():
                    setattr(kn, k, orig)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts[name] = c = kn.launch_counts()
            pngs = ex_check_figures(name, res, out_dir, figures)
            # the multiresolution example's object-tree fit ends below its
            # start at the fast depth (10 iterations), in the JAX package
            # too; its batched fit improves at both depths
            if name != "multiresolution" or not EX_FAST:
                _logL_improves(res, "logL", name)
            if name == "multiresolution":
                _logL_improves(res, "batched_logL", name)
            if name == "quickstart":
                _logL_improves(res, "refit_logL", name)
            want = PATH_KERNELS if name in EX_K34 else ("monotonic_prox",)
            missing = [k for k in want if c[k] == 0]
            if missing:
                raise AssertionError(f"{name}: kernels {missing} launched "
                                     f"no time: {c}")
            checks[name] = ex_kernel_checks(stores, name, card)
            summary[name] = dict(
                wall_s=wall, seconds=res["seconds"],
                iterations=res.get("iterations"), logL=res["logL"],
                refit_logL=res.get("refit_logL"),
                panels={f: len(v) for f, v in res["panels"].items()},
                pngs=pngs, launches={k: int(c[k]) for k in PATH_KERNELS},
                new_shapes={k: len(v) for k, v in checks[name].items()})
            secs = ", ".join(f"{k} {v:.2f} s"
                             for k, v in res["seconds"].items())
            log(f"example {name} ({'fast' if EX_FAST else 'full'} depth, "
                f"figures {figures}): "
                f"wall {wall:.2f} s ({secs}); iterations "
                f"{res.get('iterations')}, logL {res['logL'][0]:.6g} -> "
                f"{res['logL'][1]:.6g}; figures' RGB panels "
                f"{summary[name]['panels']}; PNGs {pngs}; launches K1 "
                f"{c['monotonic_prox']}, K3 {c['scene_assembly']}, K4 "
                f"{c['grad_gather']}; new shapes checked "
                f"{summary[name]['new_shapes']}; on {card}")
            if name == "quickstart":
                summary["display_panels_card_vs_cpu"] = ex_display_devices(
                    dev, inputs[name], os.path.join(out_dir,
                                                    "hsc_cosmos_35.sca"),
                    card)
    summary["starlet_monotonic"] = ex_starlet_monotonic(
        dev, inputs["starlet_source"], card)
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"examples phase: {summary['phase_s']:.1f} s on {card}")
    return counts, checks, summary


# ---------------------------------------------------------------------------
# 15. the host C library (scarlet_tpu_torch.native) on the host paths
# ---------------------------------------------------------------------------
# runs of each number the phase re-measures (median and spread)
NATIVE_RUNS = 3
# worker processes holding the sweep and the fills to their numpy twins
NATIVE_WORKERS = 8
# the labels' threshold on a detection image, in its robust sigmas
NATIVE_LABEL_SIGMAS = 3.0


def _spread(values):
    values = [float(v) for v in values]
    return dict(median=float(np.median(values)), min=min(values),
                max=max(values), runs=values)


def _fmt(sp, unit="", digits=3, scale=1.0):
    sp = {k: (v * scale if k != "runs" else v) for k, v in sp.items()}
    return (f"{sp['median']:.{digits}f}{unit} (median of {len(sp['runs'])}; "
            f"{sp['min']:.{digits}f}..{sp['max']:.{digits}f})")


def jacobi_monotonic_morph(detect, center, full_box, grow=0, normalize=True,
                           use_mask=True, thresh=0):
    """``lite.init_monotonic_morph(use_mask=False)`` by the plain Jacobi
    route the port took before its C library: the projection
    (``ops.prox.prox_weighted_monotonic``, torch on the CPU) at
    ``monotonic_depth`` passes in ``detect``'s dtype, then the trim."""
    import torch
    from scarlet_tpu_torch.bbox import Box
    from scarlet_tpu_torch.initialization import trim_morphology
    from scarlet_tpu_torch.ops import prox as prox_ops

    assert not use_mask
    weights = prox_ops.monotonic_weights(detect.shape, "angle", center)
    n_iter = prox_ops.monotonic_depth(weights, detect.shape, center)
    morph = prox_ops.prox_weighted_monotonic(
        torch.from_numpy(np.ascontiguousarray(detect)), weights, n_iter,
        min_gradient=0, center=center).numpy()
    morph, bbox = trim_morphology(center, morph, bg_thresh=thresh)
    if np.max(morph) == 0:
        return Box((0, 0, 0)), None
    if normalize:
        morph = morph / np.max(morph)
    return bbox, morph


def plain_monotonic_mask(X, center, center_radius, variance, max_iter):
    """``ops.prox.prox_monotonic_mask`` composed of the C functions'
    numpy twins (``native.plain_*``)."""
    from scarlet_tpu_torch import native
    from scarlet_tpu_torch.ops import prox as prox_ops

    if center_radius > 0:
        i, j = prox_ops.get_center(X, center, center_radius)
    else:
        i, j = int(np.round(center[0])), int(np.round(center[1]))
    i, j = int(i), int(j)
    unchecked = np.ones(X.shape, np.uint8)
    unchecked[i, j] = 0
    orphans = np.zeros(X.shape, np.uint8)
    bounds = np.array([i, i, j, j], np.int32)
    X32 = np.ascontiguousarray(X, np.float32)
    native.plain_get_valid_monotonic_pixels(X32, i, j, unchecked, orphans,
                                            variance, bounds)
    model = X32.copy()
    it = 0
    while np.sum((orphans > 0) & (unchecked > 0)) > 0 and it < max_iter:
        it += 1
        rows, cols = np.where(orphans > 0)
        native.plain_linear_interpolate_invalid_pixels(
            rows, cols, unchecked, model, orphans, variance, True, bounds)
    valid = (unchecked == 0) & (orphans == 0)
    return valid, (model * valid).astype(X.dtype), bounds


def native_twin_job(job):
    """One worker's share of the twin checks (one torch thread):
    ``("seeds", items)``, items (detect, center, kwargs, (bbox, morph)) of
    the host init's ``init_monotonic_morph`` calls: the C sweep against
    its twin and the seed against the plain Jacobi route;
    ``("masks", items)``, items (plane, center, radius, variance,
    max_iter, (valid, model, bounds)) of the starlet fit's
    ``prox_monotonic_mask`` calls: the fit's result and the C library's
    here against the twins'.
    Returns (items, mismatches, C seconds, twin seconds, Jacobi
    seconds)."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scarlet_tpu_torch import native
    from scarlet_tpu_torch.ops import prox as prox_ops

    kind, items = job
    bad, c_s, twin_s, ref_s = [], 0.0, 0.0, 0.0
    for n, item in enumerate(items):
        if kind == "seeds":
            detect, center, kw, (bbox, morph) = item
            H, W = detect.shape
            weights = prox_ops.getRadialMonotonicWeights(
                detect.shape, "angle", center).astype(np.float32)
            offsets = np.array([W * dy + dx for dy, dx in
                                prox_ops.NEIGHBOR_OFFSETS], np.int64)
            didx = prox_ops.sort_by_radius(detect.shape, center)[1:]
            flat = detect.astype(np.float32).reshape(-1)
            t0 = time.perf_counter()
            got = native.prox_weighted_monotonic(flat.copy(), weights,
                                                 offsets, didx, 0.0)
            t1 = time.perf_counter()
            twin = native.plain_prox_weighted_monotonic(
                flat.copy(), weights, offsets, didx, 0.0)
            t2 = time.perf_counter()
            jbox, jmorph = jacobi_monotonic_morph(detect, center, None, **kw)
            t3 = time.perf_counter()
            same_seed = (morph is None) == (jmorph is None) and (
                morph is None or (bbox.shape == jbox.shape
                                  and bbox.origin == jbox.origin
                                  and np.array_equal(morph, jmorph)))
            if not (np.array_equal(got, twin) and same_seed):
                bad.append(n)
        else:
            plane, center, radius, variance, max_iter, fit_out = item
            t0 = time.perf_counter()
            got = prox_ops.prox_monotonic_mask(plane, 0, center, radius,
                                               variance, max_iter)
            t1 = time.perf_counter()
            twin = plain_monotonic_mask(plane, center, radius, variance,
                                        max_iter)
            t2 = t3 = time.perf_counter()
            if not all(np.array_equal(a, b) and np.array_equal(a, c)
                       for a, b, c in zip(fit_out, got, twin)):
                bad.append(n)
        c_s += t1 - t0
        twin_s += t2 - t1
        ref_s += t3 - t2
    return len(items), bad, c_s, twin_s, ref_s


def _twin_jobs(kind, items, workers):
    chunks = [items[k::workers] for k in range(workers)]
    return [(kind, c) for c in chunks if c]


def native_phase(dev, card, built, hp_summary, ex_summary, sl_summary):
    """The host C library: its build (done at the start of the run, the
    first thing that needed it), the five C functions against their numpy
    twins at the host paths' shapes, all 128 host-path blends' seeds
    against the plain Jacobi route, and the numbers the library moves,
    NATIVE_RUNS runs each: the host init s per 128, the pipeline's
    ``init_s`` and blends/min (step 13's steady runs), the monotonic starlet
    fit's mask share, and the starlet phase's mask counts.  Returns the
    summary."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from scarlet_tpu_torch import lite, native
    from scarlet_tpu_torch.lite import initialization as linit
    from scarlet_tpu_torch.ops import interpolation
    from scarlet_tpu_torch.ops import prox as prox_ops
    from scarlet_tpu_torch.testing import example_data, generate_blend

    t_phase = time.perf_counter()
    path, build_s, cxx, _ = built
    summary = dict(library=path.name, build_s=build_s, compiler=cxx)

    # the host init of the 128 blends: one run recording every seed call,
    # then NATIVE_RUNS timed runs
    rng = np.random.default_rng(SEED)
    raw = [generate_blend(rng) for _ in range(N_BLENDS)]
    seed_calls = []
    orig = linit.init_monotonic_morph

    def recorded(detect, center, full_box, **kw):
        out = orig(detect, center, full_box, **kw)
        if not kw.get("use_mask", True):
            seed_calls.append((np.array(detect), tuple(center), kw, out))
        return out

    linit.init_monotonic_morph = recorded
    try:
        for d in raw:
            parameterized(lite, build_seeds(lite, d))
    finally:
        linit.init_monotonic_morph = orig
    init_s = []
    for _ in range(NATIVE_RUNS):
        t0 = time.perf_counter()
        for d in raw:
            parameterized(lite, build_seeds(lite, d))
        init_s.append((time.perf_counter() - t0) * 128 / N_BLENDS)
    summary["host_init_s_per_128"] = _spread(init_s)

    # the starlet recipe with monotonic=True: one run recording every
    # plane the mask projection sees, then NATIVE_RUNS timed runs
    data = example_data.hsc_cosmos_35()
    mask_calls = []
    orig_mask = prox_ops.prox_monotonic_mask

    def recorded_mask(X, step=0, center=None, center_radius=1,
                      variance=0.0, max_iter=3):
        out = orig_mask(X, step, center, center_radius, variance, max_iter)
        mask_calls.append((np.array(X), center, center_radius, variance,
                           max_iter, out))
        return out

    prox_ops.prox_monotonic_mask = recorded_mask
    try:
        ex_starlet_monotonic(dev, data, card)
    finally:
        prox_ops.prox_monotonic_mask = orig_mask
    mono = [ex_starlet_monotonic(dev, data, card)
            for _ in range(NATIVE_RUNS)]
    summary["starlet_monotonic"] = dict(
        share=_spread([m["share"] for m in mono]),
        host_projection_s=_spread([m["host_projection_s"] for m in mono]),
        fit_s=_spread([m["fit_s"] for m in mono]),
        calls=[m["calls"] for m in mono], planes=[m["planes"] for m in mono],
        iterations=[m["iterations"] for m in mono],
        logL=[m["logL"] for m in mono],
        examples_phase_share=ex_summary["starlet_monotonic"]["share"])

    # the sweep, the seeds and the fills against their twins, in workers
    workers = min(NATIVE_WORKERS, os.cpu_count())
    t0 = time.perf_counter()
    jobs = _twin_jobs("seeds", seed_calls, workers) + \
        _twin_jobs("masks", mask_calls, workers)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(native_twin_job, jobs))
    twin_wall = time.perf_counter() - t0
    n_seed_jobs = len(_twin_jobs("seeds", seed_calls, workers))
    for label, res in (("seeds", results[:n_seed_jobs]),
                       ("masks", results[n_seed_jobs:])):
        n = sum(r[0] for r in res)
        bad = sum(len(r[1]) for r in res)
        summary[f"twins_{label}"] = dict(
            items=n, mismatches=bad, c_s=sum(r[2] for r in res),
            twin_s=sum(r[3] for r in res), jacobi_s=sum(r[4] for r in res))
        if n == 0 or bad:
            raise AssertionError(f"native {label}: {bad} of {n} differ from "
                                 "their twins or the Jacobi route")
    ts, tm = summary["twins_seeds"], summary["twins_masks"]
    shapes = sorted({m[0].shape for m in mask_calls})
    log(f"host C library ({summary['library']}, built in {build_s:.2f} s by "
        f"{cxx}): the sweep on the {ts['items']} seeds of the {N_BLENDS} "
        f"host-path blends (detection images {seed_calls[0][0].shape}) "
        f"equals its numpy twin bit for bit, and every seed the plain "
        f"Jacobi route's (C {1e3 * ts['c_s'] / ts['items']:.3f} ms, twin "
        f"{1e3 * ts['twin_s'] / ts['items']:.2f} ms, Jacobi "
        f"{1e3 * ts['jacobi_s'] / ts['items']:.2f} ms per seed, one "
        f"thread); the fill with orphans on the {tm['items']} starlet "
        f"planes of the monotonic starlet fit (shapes {shapes}) equals the "
        f"twins' bit for bit (C {1e3 * tm['c_s'] / tm['items']:.3f} ms, "
        f"twins {1e3 * tm['twin_s'] / tm['items']:.2f} ms per plane); "
        f"{workers} workers, {twin_wall:.1f} s")

    # apply_filter with each blend's first PSF on its detection image, and
    # the labels of the thresholded detection image
    filt = dict(c_s=0.0, twin_s=0.0)
    lab = dict(c_s=0.0, twin_s=0.0, components=[])
    for d in raw:
        detect = np.sum(d["images"] / d["variance"].mean(axis=(1, 2))[
            :, None, None], axis=0).astype(np.float32)
        psf = d["psfs"][0].astype(np.float32)
        coords = interpolation.get_filter_coords(psf)
        fb = interpolation.get_filter_bounds(coords.reshape(-1, 2))
        t0 = time.perf_counter()
        got = native.apply_filter(detect, psf.reshape(-1), *fb)
        t1 = time.perf_counter()
        twin = native.plain_apply_filter(detect, psf.reshape(-1), *fb)
        t2 = time.perf_counter()
        filt["c_s"] += t1 - t0
        filt["twin_s"] += t2 - t1
        if not np.array_equal(got, twin):
            raise AssertionError("native apply_filter differs from its twin")
        sigma = 1.4826 * np.median(np.abs(detect - np.median(detect)))
        thresh = float(NATIVE_LABEL_SIGMAS * sigma)
        t0 = time.perf_counter()
        labels, n = native.label_components(detect, thresh)
        t1 = time.perf_counter()
        tl, tn = native.plain_label_components(detect, thresh)
        t2 = time.perf_counter()
        lab["c_s"] += t1 - t0
        lab["twin_s"] += t2 - t1
        lab["components"].append(n)
        if n != tn or not np.array_equal(labels, tl) or n == 0:
            raise AssertionError(f"native label_components: {n} against the "
                                 f"twin's {tn}, labels equal "
                                 f"{np.array_equal(labels, tl)}")
    summary["apply_filter"] = dict(filter=list(raw[0]["psfs"][0].shape),
                                   image=list(detect.shape), **filt)
    summary["label_components"] = lab
    log(f"host C library: apply_filter with each blend's "
        f"{raw[0]['psfs'][0].shape} PSF on its {detect.shape} detection "
        f"image ({N_BLENDS} calls) equals its twin bit for bit (C "
        f"{1e3 * filt['c_s'] / N_BLENDS:.3f} ms, twin "
        f"{1e3 * filt['twin_s'] / N_BLENDS:.2f} ms per call); "
        f"label_components at {NATIVE_LABEL_SIGMAS} sigma equals its twin "
        f"bit for bit ({min(lab['components'])}..{max(lab['components'])} "
        f"components; C {1e3 * lab['c_s'] / N_BLENDS:.3f} ms, twin "
        f"{1e3 * lab['twin_s'] / N_BLENDS:.2f} ms per image)")

    first, *runs = hp_summary["pipeline"]["runs"]
    summary["pipeline"] = dict(
        init_s=_spread([r["init_s"] for r in runs]),
        blends_per_min=_spread([r["blends_per_min"] for r in runs]),
        wall_s=_spread([r["wall_s"] for r in runs]),
        first_run=first)
    summary["starlet_phase_mask_counts"] = sl_summary["lsbg"][
        "mask_constraint"]
    sm = summary["starlet_monotonic"]
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"host C library, re-measured: host init "
        f"{_fmt(summary['host_init_s_per_128'], ' s')} per 128 blends in "
        f"process; pipeline init_s "
        f"{_fmt(summary['pipeline']['init_s'], ' s')}, "
        f"{_fmt(summary['pipeline']['blends_per_min'], ' blends/min', 1)} "
        f"in its steady runs (the first "
        f"{first['blends_per_min']:.1f} blends/min, set-up "
        f"{first['setup_s']:.3f} s); the monotonic starlet fit's mask share "
        f"{_fmt(sm['share'], '%', 2, 100.0)} "
        f"({sm['calls'][0]} calls, {sm['planes'][0]} planes, fit "
        f"{_fmt(sm['fit_s'], ' s')}); the starlet phase's mask counts "
        f"{summary['starlet_phase_mask_counts']}; phase "
        f"{summary['phase_s']:.1f} s on {card}")
    return summary


# ---------------------------------------------------------------------------
# 16. The JAX package's last stream and engine options: quantized uploads,
# the upload bandwidth probe and the bf16 tiers of the DFT convolution
# ---------------------------------------------------------------------------
UPLOAD_RUNS = 3     # het stream runs of each upload form, in turns
TIER_NAMES = ("float32", "high", "default")
# a tier convolution against float64, as a share of its largest value: the
# tier's own error (the CPU tests measure 4.0e-3 to 4.3e-3 at one pass and
# 6.7e-6 to 7.8e-6 at three) and, below, float32's (~3e-7): a tier that
# fell back to float32, or to a bf16 result, leaves its band
TIER_ERR = {"high": (1e-6, 1e-4), "default": (1e-4, 2e-2)}
# the bf16 product on the card against its plain version on the CPU, on
# the same operands (exact products; float32 sums in another order)
BF16_PRODUCT_RTOL = 1e-6


def _stream_records_key(records):
    return [(r["iterations"], r["logL"], r["n_components"],
             np.asarray(r["flux"]).tobytes()) for r in records]


def _het_stream(dev, het, stacks, **kw):
    """One device-stream run of the het cell on ``stacks`` (images,
    variance, psfs): (result, wall s after a synchronize)."""
    import torch
    from scarlet_tpu_torch.parallel import stream

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stream.deblend_device_stream(
        *stacks, het["centers"], model_psf(), center_active=het["active"],
        device=dev, **dict(HET, **kw))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _staging(dev, stacks, qdtype):
    """The bulk path's two halves for ``stacks`` at ``qdtype``: host s to
    quantize into pinned memory (host clock), device ms of the copies
    (CUDA events), bytes copied."""
    import torch
    from scarlet_tpu_torch.parallel import stream

    t0 = time.perf_counter()
    staged = [stream._host_stack(x, qdtype, pin=True) for x in stacks]
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for t in staged:
        t.to(dev, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return dict(host_s=host_s, upload_ms=start.elapsed_time(end),
                bytes=int(sum(t.numel() * t.element_size() for t in staged)))


def _init_changes(dev, het, qdtype):
    """Het blends whose init decisions the quantization moves: the
    float32 stacks and their quantized values (cast back to float32)
    through ``stream_setup`` chunk by chunk; a blend counts where its box
    sizes, origins, active slots, splits, PSF fallbacks or component
    count differ."""
    import torch
    from scarlet_tpu_torch.parallel import stream

    changed = {k: set() for k in ("boxes", "origins", "components",
                                  "split", "psf_fallback")}
    mp = model_psf()
    for lo in range(0, N_HET, HET["chunk"]):
        sl = slice(lo, lo + HET["chunk"])
        outs = []
        for q in (None, qdtype):
            x = [torch.from_numpy(het[k][sl]) for k in
                 ("images", "variance", "psfs")]
            if q is not None:
                x = [t.to(q).to(torch.float32) for t in x]
            outs.append(stream.stream_setup(
                *(t.to(dev) for t in x), het["centers"][sl], mp,
                center_active=het["active"][sl], box_size=HET["box_size"],
                n_slots=HET["n_slots"], device=dev))
        (_, d0, s0, a0), (_, d1, s1, a1) = outs
        diffs = dict(
            boxes=(d0.box_masks[0].sum(dim=(-2, -1))
                   != d1.box_masks[0].sum(dim=(-2, -1))).any(dim=1),
            origins=(s0.origins[0] != s1.origins[0]).any(dim=-1).any(dim=1),
            components=a0["n_active"].reshape(-1)
            != a1["n_active"].reshape(-1),
            split=(a0["split"] != a1["split"]).reshape(
                a0["split"].shape[0], -1).any(dim=1),
            psf_fallback=(a0["psf_fallback"] != a1["psf_fallback"]).reshape(
                a0["psf_fallback"].shape[0], -1).any(dim=1))
        for k, v in diffs.items():
            changed[k].update(lo + int(i) for i in
                              torch.nonzero(v).reshape(-1).cpu())
    out = {k: sorted(v) for k, v in changed.items()}
    out["any"] = sorted(set().union(*changed.values()))
    return out


def _drift(records, ref):
    """Per blend: |logL - ref| / |ref| and max |flux - ref flux| / max
    |ref flux|."""
    dl = np.array([abs(a["logL"] - b["logL"]) / abs(b["logL"])
                   for a, b in zip(records, ref)])
    df = []
    for a, b in zip(records, ref):
        fa, fb = np.asarray(a["flux"]), np.asarray(b["flux"])
        ok = np.isfinite(fa) & np.isfinite(fb)
        scale = np.abs(fb[ok]).max() if ok.any() else 1.0
        df.append(float(np.abs(fa[ok] - fb[ok]).max() / scale)
                  if ok.any() else 0.0)
    return dl, np.array(df)


def upload_phase(dev, card, het):
    """(a) ``upload_dtype=torch.bfloat16`` on the het stream, bulk and
    overlap, in turns with float32; (b) ``upload="auto"``.  Returns
    (launch counts of one bf16 bulk run, summary)."""
    import logging

    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import stream

    q = torch.bfloat16
    host_in = (het["images"], het["variance"], het["psfs"])
    # the quantized stacks on the card, bit for bit the plain rounding
    for name, x in zip(("images", "variance", "psfs"), host_in):
        plain = torch.from_numpy(x).to(q)
        up = stream._upload(x, dev, q)
        staged = stream._host_stack(x[HET["chunk"]:], q, pin=True)
        torch.cuda.synchronize()
        if not (torch.equal(up.cpu().view(torch.int16),
                            plain.view(torch.int16))
                and torch.equal(staged.view(torch.int16),
                                plain[HET["chunk"]:].view(torch.int16))):
            raise AssertionError(f"the quantized {name} stack is not the "
                                 "host rounding's bits")
    staging = {}
    for label, qd in (("float32", None), ("bfloat16", q)):
        runs = [_staging(dev, host_in, qd) for _ in range(UPLOAD_RUNS)]
        staging[label] = dict(
            bytes=runs[0]["bytes"],
            host_s=sorted(r["host_s"] for r in runs),
            upload_ms=sorted(r["upload_ms"] for r in runs))

    forms = {"float32 bulk": dict(upload="bulk"),
             "bfloat16 bulk": dict(upload="bulk", upload_dtype=q),
             "float32 overlap": dict(upload="overlap"),
             "bfloat16 overlap": dict(upload="overlap", upload_dtype=q)}
    for kw in forms.values():
        _het_stream(dev, het, host_in, **kw)
    walls = {f: [] for f in forms}
    recs = {}
    for r in range(UPLOAD_RUNS):
        for f, kw in forms.items():
            if r == 0 and f == "bfloat16 bulk":
                kn.reset_launch_counts()
            res, t = _het_stream(dev, het, host_in, **kw)
            if r == 0 and f == "bfloat16 bulk":
                counts = kn.launch_counts()
            walls[f].append(t)
            key = _stream_records_key(res[0])
            if f in recs and recs[f][1] != key:
                raise AssertionError(f"het stream {f}: records differ "
                                     "between runs")
            recs.setdefault(f, (res[0], key))
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "bf16-upload stream")
    for a, b in (("float32 bulk", "float32 overlap"),
                 ("bfloat16 bulk", "bfloat16 overlap")):
        if recs[a][1] != recs[b][1]:
            raise AssertionError(f"het stream: {a} and {b} records differ")
    r16, r32 = recs["bfloat16 bulk"][0], recs["float32 bulk"][0]
    for i, r in enumerate(r16):
        if not (np.isfinite(r["logL"]) and np.all(np.isfinite(r["flux"]))):
            raise AssertionError(f"bf16-upload stream record {i} is not "
                                 "finite")
    dl, df = _drift(r16, r32)
    comp = [i for i, (a, b) in enumerate(zip(r16, r32))
            if a["n_components"] != b["n_components"]]
    changes = _init_changes(dev, het, q)
    bpm = {f: [N_HET / t * 60.0 for t in w] for f, w in walls.items()}

    # (b) "auto": the probe, then a run that it decides, as bulk's bits
    probe = [stream._upload_bandwidth_mbs(dev) for _ in range(3)]
    chosen = []

    class Grab(logging.Handler):
        def emit(self, record):
            chosen.append(record.args)

    log_ = logging.getLogger("scarlet_tpu_torch.parallel.stream")
    grab, level = Grab(), log_.level
    log_.addHandler(grab)
    log_.setLevel(logging.INFO)
    try:
        auto, auto_s = _het_stream(dev, het, host_in, upload="auto")
    finally:
        log_.removeHandler(grab)
        log_.setLevel(level)
    if len(chosen) != 1 or \
            _stream_records_key(auto[0]) != recs["float32 bulk"][1]:
        raise AssertionError(f"upload='auto' ({chosen}) did not give the "
                             "bulk records")
    summary = dict(
        staging=staging, blends_per_min=bpm,
        logL_rel_drift=dict(median=float(np.median(dl)),
                            p95=float(np.percentile(dl, 95)),
                            max=float(dl.max()), argmax=int(dl.argmax())),
        flux_rel_drift=dict(median=float(np.median(df)),
                            p95=float(np.percentile(df, 95)),
                            max=float(df.max())),
        component_count_changed=comp, init_changes=changes,
        probe_mbs=probe, auto=dict(measured_mbs=float(chosen[0][0]),
                                   mode=chosen[0][1], wall_s=auto_s))
    log(f"upload_dtype=bfloat16 on the het stream ({N_HET} blends): bytes "
        f"{staging['bfloat16']['bytes']} vs float32 "
        f"{staging['float32']['bytes']}; host quantize into pinned memory "
        f"{[round(x, 4) for x in staging['bfloat16']['host_s']]} s vs pin "
        f"only {[round(x, 4) for x in staging['float32']['host_s']]} s; "
        f"upload {[round(x, 3) for x in staging['bfloat16']['upload_ms']]} "
        f"ms vs {[round(x, 3) for x in staging['float32']['upload_ms']]} "
        f"ms (events) on {card}")
    for f, v in bpm.items():
        log(f"  het stream {f}: blends/min {[round(x, 1) for x in v]} "
            f"(median {np.median(v):.1f}) on {card}")
    log(f"  bf16 against float32 records: logL rel drift median "
        f"{np.median(dl):.3g}, p95 {np.percentile(dl, 95):.3g}, max "
        f"{dl.max():.3g} (blend {int(dl.argmax())}); flux drift median "
        f"{np.median(df):.3g}, p95 {np.percentile(df, 95):.3g}, max "
        f"{df.max():.3g}; component counts changed in {len(comp)} blends "
        f"{comp}; init decisions moved in {len(changes['any'])} blends "
        f"(boxes {changes['boxes']}, origins {changes['origins']}, "
        f"components {changes['components']}, splits {changes['split']}, "
        f"PSF fallbacks {changes['psf_fallback']}); bulk and overlap "
        "records bit for bit; the quantized stacks bit for bit the host "
        "rounding")
    log(f"upload='auto': probe {[round(x, 1) for x in probe]} MB/s; the "
        f"stream measured {chosen[0][0]:.1f} MB/s and chose "
        f"{chosen[0][1]!r} (threshold 100 MB/s); records bit for bit with "
        f"bulk, {auto_s:.3f} s on {card}")
    log(f"bf16-upload stream kernel launches (one run): {counts}")
    return counts, summary


def tier_convolutions(dev, card, setup):
    """The DFT convolution at each tier at the host path's shapes: device
    ms (kernels summed, ``torch.profiler``) and events ms beside cuFFT's,
    the error against float64, the bf16 GEMMs a tier call launches, and
    its four products against their plain version on the CPU."""
    import torch
    from scarlet_tpu_torch.lite import engine
    from scarlet_tpu_torch.ops import fft

    config, data, state = setup
    C, H, W = config.scene_shape
    scene = engine.make_scene(state, config).contiguous()
    kr = data.kernel_rfft
    ref64 = fft.convolve_fft(scene.cpu().double(),
                             kr.cpu().to(torch.complex128), config.fft_shape)
    scale = float(ref64.abs().max())
    calls = {"fft": lambda: fft.convolve_fft(scene, kr, config.fft_shape)}
    for tier in TIER_NAMES:
        ops = fft.dft_conv_operators((H, W), config.fft_shape, torch.float32,
                                     dev, tier)
        calls[tier] = lambda ops=ops: fft.convolve_dft(scene, kr, ops)
    out = {}
    reps = 20
    for name, f in calls.items():
        res = f()
        r = out[name] = dict(
            event_ms=time_ms(f, reps), dtype=str(res.dtype),
            rel_err=float((res.cpu().double() - ref64).abs().max()) / scale,
            ms=None, launches=None, bf16_gemms=None, gemm_kernel=None)
        # one profiled window of ``reps`` calls: device ms, kernels per
        # call and the bf16 GEMMs among them.  The profiler has come back
        # empty late in a full run: then CUDA events alone, said so
        try:
            kern = kernel_events(f, reps)
        except AssertionError as e:
            log(f"convolution {name}: {e}; CUDA events only")
            continue
        gemm = [e.name for e in kern
                if "gemm" in e.name.lower() and "bf16" in e.name.lower()]
        r.update(ms=sum(e.time_range.elapsed_us() for e in kern) / reps
                 / 1e3, launches=len(kern) / reps,
                 bf16_gemms=len(gemm) / reps,
                 gemm_kernel=gemm[0] if gemm else None)
    # no fall-back: float32 runs no bf16 GEMM and keeps float32's error;
    # each tier lies in its own error band, with a float32 result (its
    # products against their plain version follow)
    f32_err = out["float32"]["rel_err"]
    if out["float32"]["bf16_gemms"] or f32_err > 1e-5:
        raise AssertionError("the float32 DFT route left float32")
    for tier, (lo, hi) in TIER_ERR.items():
        r = out[tier]
        if r["dtype"] != "torch.float32" or r["bf16_gemms"] == 0 \
                or not lo < r["rel_err"] < hi or r["rel_err"] < 5 * f32_err:
            raise AssertionError(f"DFT tier {tier!r}: {r}")
    # the four products of one tier call, card against the CPU plain
    # version on the card's own operands
    prod = {}
    orig = fft.bf16_matmul
    for tier in ("high", "default"):
        seen = []

        def spy(a, b, passes):
            res = orig(a, b, passes)
            seen.append((a, b, passes, res))
            return res

        fft.bf16_matmul = spy
        try:
            calls[tier]()
        finally:
            fft.bf16_matmul = orig
        errs = []
        for a, b, passes, res in seen:
            plain = orig(a.cpu(), b.cpu(), passes)
            errs.append(float((res.cpu() - plain).abs().max())
                        / float(plain.abs().max()))
        prod[tier] = dict(products=len(seen), rel_errs=errs,
                          shapes=[f"{tuple(a.shape)}x{tuple(b.shape)}"
                                  for a, b, _, _ in seen])
        if len(seen) != 4 or max(errs) > BF16_PRODUCT_RTOL:
            raise AssertionError(f"tier {tier!r}: bf16 products against "
                                 f"their plain version {errs}")
    for name, r in out.items():
        prof = ("not profiled" if r["ms"] is None else
                f"{r['ms']:.4f} ms device in {r['launches']:.1f} kernels, "
                f"{r['bf16_gemms']:.2f} bf16 GEMMs per call")
        log(f"convolution {name} at B={scene.shape[0]} C={C} {H}x{W} fft "
            f"{config.fft_shape}: {prof} ({r['event_ms']:.4f} ms events), "
            f"rel err vs float64 {r['rel_err']:.3g}, {r['dtype']} out"
            + (f" ({r['gemm_kernel'][:80]})" if r["gemm_kernel"] else "")
            + f" on {card}")
    for tier, p in prod.items():
        log(f"  {tier}: its {p['products']} bf16 products {p['shapes']} "
            f"against the CPU plain version: rel err "
            f"{[f'{e:.3g}' for e in p['rel_errs']]} (limit "
            f"{BF16_PRODUCT_RTOL})")
    return dict(routes=out, products=prod)


def tier_fits(dev, card, het):
    """15-iteration loss trajectories at each tier against "float32" on
    the well-conditioned het blends, and converged fits of het chunk 0 at
    each tier in turns (blends/min, logL against float32)."""
    import torch
    from scarlet_tpu_torch.lite import engine
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import batch

    cfg, dat, st, _ = het_setup(dev, het, CPU_BLENDS)
    cfgs = {t: dataclasses.replace(cfg, conv_mode="dft", conv_precision=t)
            for t in TIER_NAMES}
    traj = {t: engine.fit_scan(st, dat, c, DFT_ITERS)[1]
            for t, c in cfgs.items()}
    rel = {t: _rel_trajectories(traj[t], traj["float32"]).tolist()
           for t in TIER_NAMES[1:]}
    cfg, dat, st, _ = het_setup(dev, het, slice(0, HET["chunk"]))
    cfgs = {t: dataclasses.replace(cfg, conv_mode="dft", conv_precision=t)
            for t in TIER_NAMES}
    for c in cfgs.values():
        batch.fit_batch_device_converged(st, dat, c, MAX_ITER, CHECK_EVERY)
    B = st.active.shape[0]
    bpm = {t: [] for t in TIER_NAMES}
    final = {}
    for r in range(DFT_RUNS):
        for t, c in cfgs.items():
            if r == 0 and t == "high":
                kn.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, _ = batch.fit_batch_device_converged(st, dat, c, MAX_ITER,
                                                    CHECK_EVERY)
            torch.cuda.synchronize()
            bpm[t].append(B / (time.perf_counter() - t0) * 60.0)
            if r == 0 and t == "high":
                counts = kn.launch_counts()
            final[t] = (o.last_loss.cpu().double().numpy(),
                        o.it.cpu().numpy())
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the "
                                 "fit at 'high'")
    drift = {}
    for t in TIER_NAMES[1:]:
        d = np.abs(final[t][0] - final["float32"][0]) / np.abs(
            final["float32"][0])
        if not np.isfinite(final[t][0]).all():
            raise AssertionError(f"tier {t!r}: non-finite logL")
        drift[t] = dict(median=float(np.median(d)), max=float(d.max()),
                        iterations_changed=int((final[t][1]
                                                != final["float32"][1])
                                               .sum()))
    for t in TIER_NAMES[1:]:
        log(f"DFT tier {t!r} against 'float32' on het blends {CPU_BLENDS} "
            f"({DFT_ITERS} iterations): loss trajectories max rel diff per "
            f"blend {[f'{x:.3g}' for x in rel[t]]}; het chunk 0 converged: "
            f"logL rel drift median {drift[t]['median']:.3g}, max "
            f"{drift[t]['max']:.3g}, {drift[t]['iterations_changed']} "
            "blends' iterations changed")
    for t, v in bpm.items():
        log(f"  het chunk 0 conv_mode='dft' at {t!r}: blends/min "
            f"{[round(x, 1) for x in v]} (median {np.median(v):.1f}) on "
            f"{card}")
    log(f"fit at 'high' kernel launches: {counts}")
    return counts, dict(trajectories=rel, chunk0_drift=drift,
                        blends_per_min=bpm)


def options_phase(dev, card, setup, het):
    """Phase 16: (a) and (b) ``upload_phase``, (c) the DFT tiers.  Returns
    ({path: launch counts}, summary)."""
    t0 = time.perf_counter()
    up_counts, up = upload_phase(dev, card, het)
    conv = tier_convolutions(dev, card, setup)
    tier_counts, fits = tier_fits(dev, card, het)
    summary = dict(upload=up, tier_convolutions=conv, tier_fits=fits,
                   wall_s=time.perf_counter() - t0)
    log(f"the options phase took {summary['wall_s']:.1f} s")
    return dict(upload_dtype=up_counts, dft_high=tier_counts), summary


# ---------------------------------------------------------------------------
# 17. Any band count (K3, K4) and any box (K5, K6) on the card
# ---------------------------------------------------------------------------
# band counts past the gather kernels' one-group instantiations (PAUS's 40
# narrow bands the largest), and those timed at the lite fit's shapes
BAND_CHECKS = (8, 9, 10, 12, 16, 40)
BAND_TIMES = (3, 5, 8, 10, 16, 40)
# K3 alone, both walks, contiguous and strided morphologies
SCENE_CHECK_BANDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 40)
BAND_REPS, BAND_GRAPH_CALLS = 10, 20
# (B, K, (H, W), box): the lite fit's shapes (K4's tiled route from 8
# bands) and a small scene (staged up to 8 bands, one tile past them)
BAND_FIT_SHAPE = (128, 16, (58, 48), 59)
BAND_STAGED_SHAPE = (32, 16, (24, 24), 21)
# the 10-band het-like stream: generated (10, 58, 48) blends, the het
# cell's settings; the card against the CPU on BAND_CPU_BLENDS of them,
# BAND_CPU_ITERS iterations at e_rel 0 (as the wavelet phase's rerun: a
# blend whose convergence test flips stops iterations apart)
BAND_STREAM_SHAPE, N_BAND_STREAM, BAND_SEED = (10, 58, 48), 64, 16
BAND_CPU_BLENDS, BAND_CPU_ITERS = [0, 1, 2, 3], 50
# the multi-resolution pair with 6 HR and 4 LR bands, card against CPU
BAND_MR_BANDS, BAND_MR_B, BAND_MR_ITERS = (6, 4), 4, 10
# boxes past the register kernels' 73 pixels: the wide engine's K1, K5
# and K6 at WIDE_BOXES (WIDE_SHAPE morphologies) and at the object tree's
# OT_WIDE_BOXES (one), and the engine fits on 5-band het blends packed at
# box 81
WIDE_BOXES = (81, 101)
WIDE_SHAPE = (4, 8)
WIDE_FIT_BOX, WIDE_FIT_BLENDS, WIDE_FIT_ITERS = 81, 32, 20
# K4's tiled route at boxes past the lite scene: (B, K, C, (H, W), box) at
# box 81 on an 80 x 80 scene and past 170 pixels (the boxes its earlier
# design refused), 16, 4, 2 and 1 components (4, 4, 4 and 8 warps a
# component)
TILED_SHAPES = ((32, 16, 5, (80, 80), 81), (4, 4, 5, (170, 170), 171),
                (2, 2, 5, (200, 200), 201), (2, 1, 5, (256, 256), 256))
# the lite fit past box 170: testing.large_galaxy (3 bands, 180 x 180) and
# a second source, one bucket forced to the cap max(H, W) + 1
BIG_FIT_SCENE, BIG_FIT_BOX, BIG_FIT_ITERS = 180, 181, 10
BIG_FIT_RTOL = 1e-4


def band_inputs(B, K, C, H, W, box, dev, seed):
    """Seeded K3/K4 inputs: seds, morphs, origins of boxes centered in the
    scene (overhanging its edges), a few slots off, and the unpadded
    gradient as the engine's inverse FFT leaves it (a strided crop)."""
    import torch

    rng = np.random.default_rng(seed)
    seds = torch.from_numpy(rng.uniform(0.1, 2, (B, K, C)).astype(
        np.float32)).to(dev)
    morphs = torch.from_numpy(rng.uniform(0, 1, (B, K, box, box)).astype(
        np.float32)).to(dev)
    cy = rng.integers(0, H, (B, K, 1))
    cx = rng.integers(0, W, (B, K, 1))
    origins = torch.from_numpy(np.concatenate(
        [cy - box // 2, cx - box // 2], -1).astype(np.int32)).to(dev)
    on = torch.from_numpy(rng.uniform(size=(B, K)) > 0.1).to(dev)
    grad = strided_gradient(B, C, H, W, (H + 2 * (box // 2),
                                         W + 2 * (box // 2)), dev)
    return seds, morphs, origins, on, grad


def band_kernel_checks(dev, card):
    """(a) K3 and K4 against their plain versions at BAND_CHECKS, on the
    lite fit's shapes and on the small scene: K3 and g_morph bit for bit,
    g_sed within GRAD_SED_RTOL of sum |g * morph| and the same bits in two
    launches, each on the unpadded gradient and padded by the box; K4's
    tiled route at every count.  Returns {C: results}."""
    import torch.nn.functional as F
    from scarlet_tpu_torch.ops import kernels as kn

    out = {}
    for C in BAND_CHECKS:
        res, routes = {}, set()
        for label, (B, K, (H, W), box) in (("fit", BAND_FIT_SHAPE),
                                           ("staged", BAND_STAGED_SHAPE)):
            seds, m, origins, on, grad = band_inputs(B, K, C, H, W, box,
                                                     dev, C + box)
            P = box
            got = kn.scene_assembly(seds, m, origins, on, (C, H, W), P)
            ref = kn.scene_assembly_plain(seds, m, origins, on, (C, H, W), P)
            scene_err = float((got - ref).abs().max())
            for gl, (g, p) in (("pad 0", (grad, 0)),
                               ("padded", (F.pad(grad, (P,) * 4), P))):
                gs, gm = kn.grad_gather(g, seds, m, origins, p)
                rs, rm = kn.grad_gather_plain(g, seds, m, origins, p)
                scale = kn.grad_gather_plain(g.abs(), seds, m, origins, p)[0]
                sed_err = float(((gs - rs).abs()
                                 / scale.clamp_min(1e-30)).max())
                again = kn.grad_gather(g, seds, m, origins, p)
                same = bool((again[0] == gs).all() and (again[1] == gm).all())
                route = kn.grad_geometry(B, K, C, *g.shape[-2:], box,
                                         box).route
                routes.add(route)
                r = dict(route=route, g_morph_err=float((gm - rm).abs().max()),
                         g_sed_rel_err=sed_err, repeat_bitwise=same)
                res[f"{label} {gl}"] = r
                if r["g_morph_err"] != 0.0 or sed_err > GRAD_SED_RTOL \
                        or not same:
                    raise AssertionError(f"grad_gather at C={C} ({label}, "
                                         f"{gl}): {r}")
            res[f"{label} scene_err"] = scene_err
            if scene_err != 0.0:
                raise AssertionError(f"scene_assembly at C={C} ({label}) "
                                     f"differs from its plain version by "
                                     f"{scene_err}")
        if "tiled" not in routes:
            raise AssertionError(f"grad_gather at C={C} ran {routes} only")
        out[C] = res
        log(f"bands C={C}: scene_assembly bit for bit at "
            f"{BAND_FIT_SHAPE} and {BAND_STAGED_SHAPE}; grad_gather "
            + "; ".join(f"{k}: {v['route']}, g_morph err "
                        f"{v['g_morph_err']:.3g}, g_sed rel err "
                        f"{v['g_sed_rel_err']:.3g}, repeat bitwise "
                        f"{v['repeat_bitwise']}"
                        for k, v in res.items() if isinstance(v, dict))
            + f" on {card}")
    return out


def scene_walk_checks(dev, card):
    """(a) K3 bit for bit against its plain version at SCENE_CHECK_BANDS
    on the lite fit's shapes, on contiguous and strided morphologies (a
    crop of a larger array), the shape's walk and, up to 8 bands, the
    staged walk forced; and at TILED_SHAPES' boxes at 5 and 12 bands.
    Returns {label: {walk, max_abs_err}}."""
    import functools

    from scarlet_tpu_torch.ops import kernels as kn

    out = {}
    B, K, (H, W), box = BAND_FIT_SHAPE
    cases = [(B, K, C, (H, W), box) for C in SCENE_CHECK_BANDS] + [
        (b, k, C, hw, bx) for b, k, _, hw, bx in TILED_SHAPES
        for C in (5, 12)]
    real = kn.scene_geometry
    for B, K, C, (H, W), box in cases:
        seds, m, origins, on, _ = band_inputs(B, K, C, H, W, box, dev,
                                              7 * C + box)
        big = m.new_zeros(B, K + 1, box + 2, box + 3)
        big[:, 1:, 1:1 + box, 2:2 + box] = m
        strided = big[:, 1:, 1:1 + box, 2:2 + box]
        ref = kn.scene_assembly_plain(seds, m, origins, on, (C, H, W), box)
        walks = [None] + (["staged"] if C <= kn.SCENE_BANDS else [])
        for walk in walks:
            try:
                if walk:
                    kn.scene_geometry = functools.partial(real, route=walk)
                for layout, mm in (("contiguous", m), ("strided", strided)):
                    got = kn.scene_assembly(seds, mm, origins, on, (C, H, W),
                                            box)
                    err = float((got - ref).abs().max())
                    label = (f"B={B} K={K} C={C} {H}x{W} box={box} {layout}"
                             + (f" {walk} forced" if walk else ""))
                    out[label] = dict(walk=kn.scene_geometry(
                        B, K, C, H, W).route, max_abs_err=err)
                    if not torch_equal(got, ref):
                        raise AssertionError(f"scene_assembly at {label} "
                                             f"differs by {err}")
            finally:
                kn.scene_geometry = real
    log(f"scene_assembly bit for bit at {len(out)} checks (C = "
        f"{', '.join(map(str, SCENE_CHECK_BANDS))} at {BAND_FIT_SHAPE}, "
        f"boxes {', '.join(str(s[-1]) for s in TILED_SHAPES)} at C = 5, 12;"
        f" contiguous and strided morphologies; staged walk forced up to 8 "
        f"bands) on {card}")
    return out


def torch_equal(a, b):
    import torch

    return bool(torch.equal(a, b))


def graph_ms(fn, reps=BAND_REPS, per=BAND_GRAPH_CALLS):
    """Device ms per call of ``fn``: ``per`` calls captured in one CUDA
    graph, each replay timed with CUDA events (``time_ms``), the median of
    ``reps`` replays over ``per``.  A replay runs no Python, so the host's
    launch gaps, which CUDA events around one call of a ~0.01 ms kernel
    measure instead of the kernel, drop out; and it needs no profiler,
    which has come back without a short kernel's launches late in a full
    run (PERF.md)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    return time_ms(graph.replay, reps) / per


def band_timings(dev, card):
    """(d) K3 and K4 at BAND_TIMES bands on the lite fit's shapes: the
    kernel's device time (``graph_ms``: CUDA events over graph replays,
    median of BAND_REPS), CUDA events around one call (median of
    BAND_REPS), the plain version's time and the bound (bytes: each input
    read once, each output written once, over HBM_BYTES_PER_S).  Returns
    {C: {kernel: numbers}}."""
    from scarlet_tpu_torch.ops import kernels as kn

    B, K, (H, W), box = BAND_FIT_SHAPE
    out = {}
    for C in BAND_TIMES:
        seds, m, origins, on, grad = band_inputs(B, K, C, H, W, box, dev,
                                                 100 + C)
        shape = (C, H, W)
        scene = kn.scene_assembly(seds, m, origins, on, shape, box)
        px = in_scene_pixels(origins, on, box, box, H, W)
        gs, gm = kn.grad_gather(grad, seds, m, origins, 0)
        sg = kn.scene_geometry(B, K, C, H, W)
        gg = kn.grad_geometry(B, K, C, H, W, box, box)
        info = kn.gather_kernel_info(B, K, C, H, W, box,
                                     box)["scene_assembly"]
        out[C] = dict(
            scene_assembly=dict(
                **bound(nbytes(seds, origins, on, scene) + 4 * px,
                        2.0 * C * px),
                ms=graph_ms(lambda: kn.scene_assembly(
                    seds, m, origins, on, shape, box)),
                event_ms=time_ms(lambda: kn.scene_assembly(
                    seds, m, origins, on, shape, box), BAND_REPS),
                plain_ms=time_ms(lambda: kn.scene_assembly_plain(
                    seds, m, origins, on, shape, box), 3),
                grid=(B, sg.bands, sg.tiles), walks=sg.walks,
                route=sg.route, band_groups=sg.NG, band_group=sg.CG,
                groups_at_once=sg.GT, threads=sg.threads,
                staged_components=sg.S,
                **{k: info[k] for k in ("registers", "spill_bytes",
                                        "blocks_per_sm")}),
            grad_gather=dict(
                **bound(nbytes(grad, seds, m, origins, gs, gm),
                        4.0 * B * K * C * box * box),
                ms=graph_ms(lambda: kn.grad_gather(grad, seds, m, origins,
                                                   0)),
                event_ms=time_ms(lambda: kn.grad_gather(
                    grad, seds, m, origins, 0), BAND_REPS),
                plain_ms=time_ms(lambda: kn.grad_gather_plain(
                    grad, seds, m, origins, 0), 3),
                route=gg.route, G=gg.G, tile_rows=gg.tile_rows,
                walks=1 if gg.staged else -(-C // gg.band_group)))
        for name, r in out[C].items():
            log(f"bands C={C} {name} at B={B} K={K} {H}x{W} box={box}: "
                f"{r['ms']:.4f} ms device (graph replays; "
                f"{r['event_ms']:.4f} ms events around one call), "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"by {r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of the bound's speed), {r['walks']} band walk(s)"
                + (f", {r['route']} route, G={r['G']}"
                   if name == "grad_gather" else
                   f", {r['route']} walk, {r['band_groups']} band group(s) "
                   f"of {r['band_group']} at most, {r['groups_at_once']} at "
                   f"once, {r['threads']} threads, {r['registers']} "
                   f"registers, {r['spill_bytes']} B spill, "
                   f"{r['blocks_per_sm']} blocks per SM") + f" on {card}")
    return out


def tiled_shape_checks(dev, card):
    """(e) K4 at TILED_SHAPES: the strided gradient (pad 0, as the fit
    calls it), contiguous and padded by box // 2 + 2, each g_morph bit for
    bit with the plain version, g_sed within GRAD_SED_RTOL of sum |g *
    morph| and two launches bitwise; the strided call's device ms (CUDA
    events over graph replays), events around one call, plain ms, route
    and bound.  Returns {shape: numbers}."""
    import torch.nn.functional as F
    from scarlet_tpu_torch.ops import kernels as kn

    out = {}
    for B, K, C, (H, W), box in TILED_SHAPES:
        seds, m, origins, _, grad = band_inputs(B, K, C, H, W, box, dev,
                                                box + C)
        P = box // 2 + 2
        calls = {}
        for name, (g, p) in (("strided", (grad, 0)),
                             ("contiguous", (grad.contiguous(), 0)),
                             ("padded", (F.pad(grad, (P,) * 4), P))):
            gs, gm = kn.grad_gather(g, seds, m, origins, p)
            rs, rm = kn.grad_gather_plain(g, seds, m, origins, p)
            scale = kn.grad_gather_plain(g.abs(), seds, m, origins, p)[0]
            sed_err = float(((gs - rs).abs() / scale.clamp_min(1e-30)).max())
            again = kn.grad_gather(g, seds, m, origins, p)
            same = bool((again[0] == gs).all() and (again[1] == gm).all())
            calls[name] = dict(
                route=kn.grad_geometry(B, K, C, *g.shape[-2:], box,
                                       box).route,
                g_morph_err=float((gm - rm).abs().max()),
                g_sed_rel_err=sed_err, repeat_bitwise=same)
            if calls[name]["g_morph_err"] != 0.0 or sed_err > GRAD_SED_RTOL \
                    or not same or calls[name]["route"] != "tiled":
                raise AssertionError(f"grad_gather at {(B, K, C, H, W, box)}"
                                     f" ({name}): {calls[name]}")
            if name == "strided":
                outs = (gs, gm)
        geo = kn.grad_geometry(B, K, C, H, W, box, box)
        r = dict(
            **bound(nbytes(grad, seds, m, origins, *outs),
                    4.0 * B * K * C * box * box),
            ms=graph_ms(lambda: kn.grad_gather(grad, seds, m, origins, 0)),
            event_ms=time_ms(lambda: kn.grad_gather(grad, seds, m, origins,
                                                    0), BAND_REPS),
            plain_ms=time_ms(lambda: kn.grad_gather_plain(
                grad, seds, m, origins, 0), 3),
            route=geo.route, G=geo.G, R=geo.R, tile_rows=geo.tile_rows,
            band_group=geo.band_group, blocks_per_sm=geo.blocks_per_sm,
            calls=calls)
        key = f"B={B} K={K} C={C} {H}x{W} box={box}"
        out[key] = r
        log(f"tiled grad_gather at {key}: {r['ms']:.4f} ms device (graph "
            f"replays; {r['event_ms']:.4f} ms events around one call), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of the "
            f"bound's speed), {geo.route} route, G={geo.G} R={geo.R} "
            f"TR={geo.tile_rows} NB={geo.band_group} "
            f"{geo.blocks_per_sm} block(s)/SM; "
            + "; ".join(f"{n}: g_morph err {c['g_morph_err']:.3g}, g_sed "
                        f"rel err {c['g_sed_rel_err']:.3g}, repeat bitwise "
                        f"{c['repeat_bitwise']}" for n, c in calls.items())
            + f" on {card}")
    return out


def big_box_fit(dev, card):
    """(f) A lite fit past box 170: the large galaxy and a second source
    (``testing.large_galaxy_engine``), one bucket of box BIG_FIT_BOX on
    the card, BIG_FIT_ITERS iterations of the engine counted from zero.
    K4 once an iteration (the tiled route), losses finite and improving,
    and held to the CPU's at BIG_FIT_RTOL (``testing.fit_gaps``) with
    every convolution in float64 on both, and with the card's
    convolutions run on the CPU.  The gap of cuFFT's float32 fit to the
    CPU's, and to the nearest CPU fit with its convolutions' results
    times 1 -/+ 2^-24, is logged: this fit turns on one float32 rounding
    of the model's scale (ROADMAP.md Queue 3, F4).  Returns (counts,
    summary)."""
    import torch
    from scarlet_tpu_torch.lite import engine
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.testing import fit_gaps, large_galaxy_engine

    config, data, state = large_galaxy_engine(dev, BIG_FIT_SCENE,
                                              BIG_FIT_BOX)
    kn.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = engine.fit_scan(state, data, config, BIG_FIT_ITERS)
    loss = loss.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3 / BIG_FIT_ITERS
    counts = kn.launch_counts()
    geo = kn.grad_geometry(1, config.bucket_counts[0], *config.scene_shape,
                           BIG_FIT_BOX, BIG_FIT_BOX)
    gaps = fit_gaps(dev, loss, BIG_FIT_ITERS, BIG_FIT_SCENE, BIG_FIT_BOX)
    summary = dict(box=BIG_FIT_BOX, scene=config.scene_shape,
                   components=config.bucket_counts[0], route=geo.route,
                   ms_per_iteration=ms, first_loss=float(loss[0]),
                   last_loss=float(loss[-1]), gaps=gaps)
    log(f"lite fit at box {BIG_FIT_BOX} on {config.scene_shape}, "
        f"{config.bucket_counts[0]} components, {BIG_FIT_ITERS} iterations: "
        f"{ms:.3f} ms/iteration, K4 {counts['grad_gather']} launches "
        f"({geo.route} route, R={geo.R}), loss {loss[0]:.6g} -> "
        f"{loss[-1]:.6g}; gap to the CPU's fit {gaps['cpu']:.3g}, to the "
        f"nearest of its fits one rounding of the model's scale apart "
        f"{gaps['rounding']:.3g} (each {gaps['rounding_each']}); held: "
        f"with the convolutions on the CPU {gaps['host_convolutions']:.3g}"
        f", with float64 convolutions {gaps['exact']:.3g} (limit "
        f"{BIG_FIT_RTOL}) on {card}")
    if counts["grad_gather"] != BIG_FIT_ITERS or geo.route != "tiled":
        raise AssertionError(f"the box {BIG_FIT_BOX} fit did not run K4's "
                             f"tiled route once an iteration: {counts}")
    if not (np.isfinite(loss).all() and loss[-1] > loss[0]):
        raise AssertionError(f"the box {BIG_FIT_BOX} fit: {loss}")
    if max(gaps["host_convolutions"], gaps["exact"]) > BIG_FIT_RTOL:
        raise AssertionError(f"the box {BIG_FIT_BOX} fit parts from the "
                             f"CPU's: {gaps}")
    return counts, summary


def band_stream(dev, card):
    """(b) The device stream on N_BAND_STREAM generated 10-band blends at
    the het cell's settings (one chunk), counted from zero; records
    finite, logL improving for all but MAX_WORSE; then BAND_CPU_BLENDS on
    the card and the CPU: the init decisions equal (``stream_setup``) and,
    over BAND_CPU_ITERS iterations at e_rel 0 and mono_tol 0, each stream
    record's logL within CPU_RTOL.  Returns (counts, summary)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import stream

    bl = stack_blends(N_BAND_STREAM, BAND_SEED, BAND_STREAM_SHAPE)
    mp = model_psf()
    kw = dict(HET, chunk=N_BAND_STREAM)

    def run(sel, device, **extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = stream.deblend_device_stream(
            bl["images"][sel], bl["variance"][sel], bl["psfs"][sel],
            bl["centers"][sel], mp, center_active=bl["active"][sel],
            device=device, **dict(kw, **extra))
        torch.cuda.synchronize()
        return res[0], time.perf_counter() - t0

    run(slice(None), dev)
    kn.reset_launch_counts()
    records, wall = run(slice(None), dev)
    counts = kn.launch_counts()
    for name in PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "10-band stream")
    for i, r in enumerate(records):
        if not (np.isfinite(r["logL"]) and np.all(np.isfinite(r["flux"]))
                and np.asarray(r["flux"]).shape[-1] == BAND_STREAM_SHAPE[0]):
            raise AssertionError(f"10-band stream record {i} is not finite "
                                 "or not 10 bands wide")
    worse = [i for i, r in enumerate(records)
             if not r["logL"] > r["init logL"]]
    if len(worse) > MAX_WORSE * len(records):
        raise AssertionError(f"logL did not improve for {len(worse)} of "
                             f"{len(records)} 10-band stream blends")

    sel = BAND_CPU_BLENDS
    setup = [stream.stream_setup(
        bl["images"][sel], bl["variance"][sel], bl["psfs"][sel],
        bl["centers"][sel], mp, center_active=bl["active"][sel],
        box_size=HET["box_size"], n_slots=HET["n_slots"], device=d)
        for d in (dev, "cpu")]
    _init_decisions_equal(setup[0], setup[1], "10-band stream")
    exact = dict(mono_tol=0.0, e_rel=0.0, max_iter=BAND_CPU_ITERS)
    card_recs, _ = run(sel, dev, **exact)
    cpu_recs, cpu_s = run(sel, "cpu", **exact)
    rel = np.array([abs(a["logL"] - b["logL"]) / abs(b["logL"])
                    for a, b in zip(card_recs, cpu_recs)])
    its = [(a["iterations"], b["iterations"])
           for a, b in zip(card_recs, cpu_recs)]
    summary = dict(blends=N_BAND_STREAM, shape=BAND_STREAM_SHAPE,
                   wall_s=wall, blends_per_min=N_BAND_STREAM / wall * 60.0,
                   median_iterations=float(np.median(
                       [r["iterations"] for r in records])),
                   not_improved=worse, cpu_blends=sel,
                   cpu_max_rel_logL=float(rel.max()),
                   iterations_card_cpu=its, cpu_wall_s=cpu_s)
    log(f"10-band stream of {N_BAND_STREAM} generated {BAND_STREAM_SHAPE} "
        f"blends: {summary['blends_per_min']:.1f} blends/min (one run after "
        f"a warm-up, {wall:.3f} s), median iterations "
        f"{summary['median_iterations']}, not improved {worse}; blends {sel} "
        f"card vs CPU ({BAND_CPU_ITERS} iterations, e_rel 0, mono_tol 0): "
        f"init decisions equal, logL max rel diff "
        f"{rel.max():.3g} (limit {CPU_RTOL}), iterations {its}; launches "
        f"{counts} on {card}")
    if not rel.max() <= CPU_RTOL:
        raise AssertionError("10-band stream: card and CPU logL disagree")
    return counts, summary


def band_multires(dev, card):
    """(b) ``MultiResFitter`` on the pair with BAND_MR_BANDS bands (10
    model channels), BAND_MR_B flux-scaled blends, BAND_MR_ITERS
    iterations on the card (counted from zero) and on the CPU: the loss
    histories within rtol 1e-4 (tests/test_torch_cuda.py's rule).
    Returns (counts, summary)."""
    import torch
    from scarlet_tpu_torch import models
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import MultiResFitter, multires_init
    from scarlet_tpu_torch.testing import blob_centers, make_pair

    hist, counts, walls = {}, None, {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        hr, lr, dh, dl = make_pair(device=d, bands=BAND_MR_BANDS)
        frame = models.Frame.from_observations([lr, hr], obs_id=1)
        sc = np.linspace(0.8, 1.2, BAND_MR_B).astype(np.float32)[
            :, None, None, None]
        datas = (dh[None] * sc, dl[None] * sc)
        weights = tuple(np.full_like(x, 400.0) for x in datas)
        init = multires_init((hr, lr), datas, blob_centers(frame, BAND_MR_B),
                             box_size=MR_BOX, n_slots=MR_SLOTS)
        fit = MultiResFitter((hr, lr), box_size=MR_BOX)
        kn.reset_launch_counts()
        t0 = time.perf_counter()
        hist[label] = fit.fit(datas, weights, *init,
                              n_iter=BAND_MR_ITERS)[4].cpu().numpy()
        if label == "card":
            torch.cuda.synchronize()
            counts = kn.launch_counts()
        walls[label] = time.perf_counter() - t0
        channels = len(frame.channels)
    rel = float((np.abs(hist["card"] - hist["cpu"])
                 / np.abs(hist["cpu"])).max())
    summary = dict(bands=BAND_MR_BANDS, channels=channels, blends=BAND_MR_B,
                   iterations=BAND_MR_ITERS, max_rel_loss=rel,
                   card_wall_s=walls["card"], cpu_wall_s=walls["cpu"])
    log(f"multi-resolution {BAND_MR_BANDS[0]} + {BAND_MR_BANDS[1]}-band pair "
        f"({channels} model channels, {BAND_MR_B} blends, {BAND_MR_ITERS} "
        f"iterations): card vs CPU loss histories max rel diff {rel:.3g} "
        f"(limit 1e-4); card {walls['card']:.2f} s, CPU {walls['cpu']:.2f} "
        f"s; launches {counts} on {card}")
    if channels != sum(BAND_MR_BANDS) or not rel <= 1e-4 or any(
            counts[n] < BAND_MR_ITERS for n in PATH_KERNELS):
        raise AssertionError("multi-resolution pair past 8 bands failed")
    return counts, summary


def wide_case(dev, card, B, K, box):
    """The wide engine's K1, K5 and K6 on B x K seeded (box, box)
    morphologies (peaked noisy profiles, moments, box masks cutting
    columns, a quarter of the slots gated off but slot 0, thresholds, the
    "angle" table at full depth): bit for bit against their plain
    versions (K1 and K5 at tol 0 and 1e-3, K6 with and without box
    masks), one launch per call (K5 and K6 launch no K1), then each timed
    at tol 0 (CUDA events, median of BAND_REPS; plain median of 3) beside
    its bound: bytes, or the operations of the passes each morphology
    runs (``mono_passes_run``; gated-off ones run none).  Returns
    {kernel: numbers}."""
    import torch
    from scarlet_tpu_torch.lite import engine
    from scarlet_tpu_torch.ops import kernels as kn

    w, keep, n_iter = engine.monotonicity_tables((box, box), 1, "angle")
    w = torch.from_numpy(w.astype(np.float32)).to(dev)
    keep = torch.from_numpy(keep.astype(np.float32)).to(dev)
    rng = np.random.default_rng(box + B)
    yy, xx = np.mgrid[:box, :box] - box // 2
    prof = np.exp(-(yy ** 2 + xx ** 2) / rng.uniform(20, 400, (B, K, 1, 1)))
    m = torch.from_numpy((prof * (1 + 0.3 * rng.uniform(
        size=(B, K, box, box)))).astype(np.float32)).to(dev)
    g = torch.from_numpy((0.1 * rng.normal(size=m.shape)).astype(
        np.float32)).to(dev)
    mom = [torch.from_numpy((0.05 * rng.normal(size=m.shape)).astype(
        np.float32)).to(dev)] + [torch.from_numpy(
            (0.01 * rng.uniform(size=m.shape)).astype(np.float32)).to(dev)
        for _ in range(2)]
    bm = torch.ones_like(m)
    bm[:, 1::3, :, :6] = 0.0
    gate = torch.from_numpy(rng.uniform(size=(B, K)) > 0.25).to(dev)
    gate[0, 0] = True
    thr = torch.from_numpy(np.where(
        rng.uniform(size=(B, K)) > 0.5, rng.uniform(0.01, 0.2, (B, K)),
        0.0).astype(np.float32)).to(dev)
    ds = torch.full((B,), 1e-2, device=dev)
    stepped = (m + g) * bm
    idx = kn.candidate_index(stepped, 1)
    opt = engine.AdaproxState(*mom)
    geo = kn._card_geometry(dev, B * K, box, box)
    info = kn.wide_kernel_info(B * K, box, box)
    shape = f"B={B} K={K} box={box} n_iter={n_iter}"

    def k1(f, tol=0.0):
        return f(stepped, idx, w, keep, n_iter, tol=tol)

    def k5(f, tol=0.0):
        return f(m, stepped, idx, w, keep, thr, gate, n_iter, tol=tol)

    def k6(f, masks=bm):
        x, o = f(m, g, opt, gate, w, keep, masks, thr, ds, n_iter)
        return torch.stack([x, *o])

    calls = dict(monotonic_prox=(k1, dict(tol=1e-3), "monotonic_prox_wide"),
                 prox_chain=(k5, dict(tol=1e-3), "prox_chain_wide"),
                 fused_morph_update=(k6, dict(masks=None),
                                     "fused_morph_update_wide"))
    # the passes each kernel's projection runs at tol 0
    m2 = 0.1 * g + 0.9 * mom[0]
    vh2 = torch.maximum(mom[2], 0.001 * (g * g) + 0.999 * mom[1])
    x1 = (m - ds[:, None, None, None] * m2 / (torch.sqrt(vh2) + 1e-8)) * bm
    work = dict(monotonic_prox=(stepped, idx, None),
                prox_chain=(stepped, idx, gate),
                fused_morph_update=(x1, kn.candidate_index(x1, 1), gate))
    io = dict(monotonic_prox=(2 * nbytes(stepped) + nbytes(idx)
                              + taps_bytes(idx, w, keep)),
              prox_chain=(nbytes(m, stepped, idx, thr, gate, m)
                          + taps_bytes(idx, w, keep)),
              fused_morph_update=(nbytes(m, g, *mom, bm, gate, thr, ds)
                                  + 4 * nbytes(m)
                                  + taps_bytes(work["fused_morph_update"][1],
                                               w, keep)))
    out = {}
    for name, (call, other, key) in calls.items():
        kern, plain = getattr(kn, name), getattr(kn, name + "_plain")
        errs = []
        for kw in (dict(), other):
            kn.reset_launch_counts()
            got = call(kern, **kw)
            counts = kn.launch_counts()
            errs.append(float((got - call(plain, **kw)).abs().max()))
            others = {k: v for k, v in counts.items() if v and k not in (
                key, "monotonic_prox", "monotonic_prox_tol_tensor")}
            if counts[key] != 1 or others or counts["monotonic_prox"] != (
                    name == "monotonic_prox"):
                raise AssertionError(f"wide {name} at {shape}: launches "
                                     f"{counts}")
        if max(errs) != 0.0:
            raise AssertionError(f"wide {name} at {shape} differs from its "
                                 f"plain version by {errs}")
        x, i, running = work[name]
        passes = mono_passes_run(x, i, w, keep, n_iter, 0.0, running)
        out[name] = dict(
            **bound(io[name], mono_ops(passes, i, w)),
            passes=int(passes.max()), max_abs_err=max(errs), shape=shape,
            R=geo.R, P=geo.P, threads=geo.threads,
            registers=info[name]["registers"],
            spill_bytes=info[name]["spill_bytes"],
            resident_clusters=info[name]["clusters"],
            ms=time_ms(lambda: call(kern), BAND_REPS),
            plain_ms=time_ms(lambda: call(plain), 3))
        r = out[name]
        log(f"wide engine {name} at {shape} (R={geo.R} CTAs a cluster, "
            f"{'P=' + str(geo.P) if geo.P else 'streamed taps'}, "
            f"{geo.threads} threads, {r['registers']} registers, "
            f"{r['spill_bytes']} B spill, {r['resident_clusters']} clusters "
            f"resident): bit for bit, {r['ms']:.4f} ms "
            f"(events), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms by {r['bound_by']} at {r['passes']} "
            f"passes on {card}")
    return out


def wide_chain_checks(dev, card):
    """(c) The wide engine's three kernels (:func:`wide_case`) at
    WIDE_BOXES on WIDE_SHAPE morphologies and at the object tree's
    OT_WIDE_BOXES on one.  Returns {kernel: {"BxKxbox": numbers}}."""
    out = {"monotonic_prox": {}, "prox_chain": {}, "fused_morph_update": {}}
    cases = [(*WIDE_SHAPE, box) for box in WIDE_BOXES] + \
        [(1, 1, box) for box in OT_WIDE_BOXES]
    for B, K, box in cases:
        for name, res in wide_case(dev, card, B, K, box).items():
            out[name][f"{B}x{K}x{box}"] = res
    return out


def wide_fits(dev, card):
    """(c) WIDE_FIT_BLENDS het blends packed at box WIDE_FIT_BOX
    (``stream_setup``, mono_tol 0) fitted WIDE_FIT_ITERS iterations three
    ways: the default (K1's ``mono_kernel_wide``), ``packed_prox_chain``
    (``chain_kernel_wide``) and ``fuse_morph`` (``fused_kernel_wide``),
    each counted from zero; K5 and K6 launch no K1.  K5 is the default's
    projection and epilogue, so its logL is the default's bit for bit;
    K6's within the fused configurations' tolerances of fused_configs.
    Returns ({config: counts}, summary)."""
    import torch
    from scarlet_tpu_torch.ops import kernels as kn
    from scarlet_tpu_torch.parallel import batch, stream

    bl = stack_blends(WIDE_FIT_BLENDS, BAND_SEED + 1)
    config, data, state, _ = stream.stream_setup(
        bl["images"], bl["variance"], bl["psfs"], bl["centers"], model_psf(),
        center_active=bl["active"], box_size=WIDE_FIT_BOX,
        n_slots=HET["n_slots"], device=dev, mono_tol=0.0)
    if config.box_shapes[0] != (WIDE_FIT_BOX, WIDE_FIT_BOX):
        raise AssertionError(f"packed boxes {config.box_shapes}")
    configs = {
        "default": config,
        "packed_prox_chain": dataclasses.replace(config,
                                                 packed_prox_chain=True),
        "fuse_morph": dataclasses.replace(config, packed_morphs=False,
                                          fuse_morph=True)}
    finals, counts, summary = {}, {}, {}
    for name, cfg in configs.items():
        kn.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, losses = batch.fit_batch_device_converged(
            state, data, cfg, WIDE_FIT_ITERS, WIDE_FIT_ITERS)
        torch.cuda.synchronize()
        counts[name] = kn.launch_counts()
        finals[name] = out.last_loss.cpu().numpy()
        summary[name] = dict(ms_per_iteration=(time.perf_counter() - t0)
                             * 1e3 / len(losses))
    for name, key in (("default", "monotonic_prox_wide"),
                      ("packed_prox_chain", "prox_chain_wide"),
                      ("fuse_morph", "fused_morph_update_wide")):
        if counts[name][key] != WIDE_FIT_ITERS or (
                name != "default" and counts[name]["monotonic_prox"]):
            raise AssertionError(f"{name} at box {WIDE_FIT_BOX} did not run "
                                 f"the wide engine once an iteration: "
                                 f"{counts[name]}")
    ref = finals["default"]
    if not np.array_equal(finals["packed_prox_chain"], ref):
        raise AssertionError("packed_prox_chain's wide kernel differs from "
                             "the default fit")
    rel = np.abs(finals["fuse_morph"] - ref) / np.abs(ref)
    med = abs(np.median(finals["fuse_morph"]) - np.median(ref)) / abs(
        np.median(ref))
    summary["fuse_morph"].update(median_rel=float(med),
                                 max_rel=float(rel.max()))
    log(f"box {WIDE_FIT_BOX} fits of {WIDE_FIT_BLENDS} het blends, "
        f"{WIDE_FIT_ITERS} iterations: packed_prox_chain logL bit for bit "
        f"with the default; fuse_morph median rel diff {med:.3g} (limit "
        f"{FUSED_MEDIAN_RTOL}), max {rel.max():.3g} (limit "
        f"{FUSED_BLEND_RTOL}); "
        + "; ".join(f"{n}: {s['ms_per_iteration']:.3f} ms/iteration, "
                    f"launches {counts[n]}" for n, s in summary.items())
        + f" on {card}")
    if not (med <= FUSED_MEDIAN_RTOL and rel.max() <= FUSED_BLEND_RTOL):
        raise AssertionError("fuse_morph at box 81 disagrees with the "
                             "default fit")
    return counts, summary


def bands_phase(dev, card):
    """Phase 17: (a) K3/K4 past 8 bands and K3 at 1-40 bands on both walks
    against their plain versions, (b)
    the 10-band stream and the 6 + 4-band multi-resolution fit, (c) K5 and
    K6 on wide boxes and their engine fits, (d) K3/K4 times at
    BAND_TIMES, (e) K4 at TILED_SHAPES, (f) the lite fit at box
    BIG_FIT_BOX.  Returns ({path: counts}, checks, summary)."""
    t0 = time.perf_counter()
    checks = dict(bands=band_kernel_checks(dev, card),
                  scene=scene_walk_checks(dev, card))
    stream_counts, stream_summary = band_stream(dev, card)
    mr_counts, mr_summary = band_multires(dev, card)
    checks["wide"] = wide_chain_checks(dev, card)
    wide_counts, wide_summary = wide_fits(dev, card)
    times = band_timings(dev, card)
    checks["tiled"] = tiled_shape_checks(dev, card)
    big_counts, big_summary = big_box_fit(dev, card)
    summary = dict(stream=stream_summary, multires=mr_summary,
                   wide_fits=wide_summary, times=times,
                   big_box_fit=big_summary,
                   wall_s=time.perf_counter() - t0)
    log(f"the bands and wide-box phase took {summary['wall_s']:.1f} s")
    return dict(stream=stream_counts, multires=mr_counts,
                wide=wide_counts, big_box_fit=big_counts), checks, summary


def main():
    import torch

    t_start = time.perf_counter()
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

    from scarlet_tpu_torch.native import build as native_build
    native_built = native_build.build()
    log(f"host C library built in {native_built[1]:.2f} s by "
        f"{native_built[2]} ({' '.join(native_build.FLAGS)}): "
        f"{native_built[0].name}")
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

    single, setup, init_s, seeds = setup_blends(dev)
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
    del single

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
    _, wav_summary = wavelet_path(
        dev, card, het, float(np.median(
            stream_summary["device_resident_wall_s"])))
    log(f"wavelet summary: {json.dumps(wav_summary)}")

    # the fit options, each path with the counts zeroed just before it
    kres["monotonic_prox_tol_tensor"] = tol_tensor_phase(dev, card, het)
    dft_summary = dft_phase(dev, card, setup, het)
    log(f"dft summary: {json.dumps(dft_summary)}")
    opt_counts, opt_summary = grow_schedule_phase(dev, card, het)
    opt_summary["oversized"] = oversized_growth(dev, card)
    fista_counts, opt_summary["fista"] = fista_host_path(dev, card, seeds)
    log(f"fit options summary: {json.dumps(opt_summary)}")

    # the sharded fit: (a) one NCCL rank on the host path's batch, (b) two
    # ranks on the card over gloo, each run with the counts zeroed just
    # before it
    sh_counts, sh_launches, sh_checks, sh_summary = sharded_phase(
        dev, card, setup)
    log(f"sharded summary: {json.dumps(sh_summary)}")
    for name in PATH_KERNELS:
        kres[name]["sharded"] = dict(
            path="parallel.fit_batch_sharded",
            launches_one_rank=int(sh_counts[name]),
            launches_two_ranks={mesh: [r[name] for r in per_rank]
                                for mesh, per_rank in sh_launches.items()},
            shapes=sh_checks[name])
    del seeds

    # the multi-resolution fit: K1, K3 and K4 counted over one aligned fit
    mr_counts, mr_checks, mr_summary = multires_phase(dev, card)
    log(f"multi-resolution summary: {json.dumps(mr_summary)}")
    for name in PATH_KERNELS:
        kres[name]["multires_shapes"] = {
            label: res[name] for label, res in mr_checks.items()}
        kres[name]["launches_multires"] = int(mr_counts[name])

    # the object tree (scarlet's quickstart): K1 counted over the cell
    ot_counts, ot_checks, ot_summary = object_tree_phase(dev, card)
    log(f"object tree summary: {json.dumps(ot_summary)}")
    kres["monotonic_prox"]["object_tree_shapes"] = ot_checks
    kres["monotonic_prox"]["launches_object_tree"] = \
        int(ot_counts["monotonic_prox"])

    # the starlet recipes: K1 counted over (a) the starlet_source cell and
    # (b) the LSBG fit, each with the counts zeroed just before it
    sl_counts, lsbg_counts, sl_checks, sl_summary = starlet_phase(dev, card)
    log(f"starlet summary: {json.dumps(sl_summary)}")
    kres["monotonic_prox"]["starlet_shapes"] = sl_checks
    kres["monotonic_prox"]["launches_starlet"] = \
        int(sl_counts["monotonic_prox"])
    kres["monotonic_prox"]["launches_lsbg"] = \
        int(lsbg_counts["monotonic_prox"])

    # the production host paths: the pipeline, the CLI (a subprocess: its
    # own counts) and the harness, each counted from zero
    log(f"the phases before the host paths took "
        f"{time.perf_counter() - t_start:.1f} s")
    hp_counts, hp_checks, hp_summary = host_paths_phase(dev, card, setup,
                                                        init_s)
    log(f"host paths summary: {json.dumps(hp_summary)}")
    for name in PATH_KERNELS:
        kres[name]["launches_pipeline"] = int(hp_counts["pipeline"][name])
        kres[name]["launches_cli"] = int(hp_counts["cli"][name])
        kres[name]["launches_harness"] = {
            pipe: int(c[name]) for pipe, c in hp_counts["harness"].items()}
        kres[name]["host_paths_shapes"] = {
            label: res[name] for label, res in hp_checks.items()}

    # the tutorial examples, each with the counts zeroed just before it
    ex_counts, ex_checks, ex_summary = examples_phase(dev, card)
    log(f"examples summary: {json.dumps(ex_summary)}")
    keep = ("shape", "max_abs_err", "g_morph_err", "g_sed_rel_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "kernel")
    for name in PATH_KERNELS:
        kres[name]["launches_examples"] = {
            ex: int(c[name]) for ex, c in ex_counts.items()}
        kres[name]["examples_shapes"] = {
            ex: [{k: r[k] for k in keep if k in r} for r in chk[name]]
            for ex, chk in ex_checks.items() if chk[name]}

    # the host C library: twins, seeds, and the numbers it moves
    native_summary = native_phase(dev, card, native_built, hp_summary,
                                  ex_summary, sl_summary)
    log(f"native summary: {json.dumps(native_summary)}")

    # the last stream and engine options, each path counted from zero
    opt16_counts, opt16_summary = options_phase(dev, card, setup, het)
    del setup
    log(f"options summary: {json.dumps(opt16_summary)}")
    for name in PATH_KERNELS:
        kres[name]["launches_upload_dtype"] = \
            int(opt16_counts["upload_dtype"][name])
        kres[name]["launches_dft_high"] = int(opt16_counts["dft_high"][name])

    # any band count (K3, K4) and any box (K5, K6): each path counted from
    # zero
    b17_counts, b17_checks, b17_summary = bands_phase(dev, card)
    log(f"bands summary: {json.dumps(b17_summary)}")
    for name in PATH_KERNELS:
        kres[name]["launches_bands_stream"] = \
            int(b17_counts["stream"][name])
        kres[name]["launches_bands_multires"] = \
            int(b17_counts["multires"][name])
    for name in ("scene_assembly", "grad_gather"):
        kres[name]["band_times"] = {
            C: t[name] for C, t in b17_summary["times"].items()}
    kres["grad_gather"]["band_checks"] = b17_checks["bands"]
    kres["scene_assembly"]["walk_checks"] = b17_checks["scene"]
    kres["grad_gather"]["tiled_shapes"] = b17_checks["tiled"]
    kres["grad_gather"]["launches_box_181_fit"] = \
        int(b17_counts["big_box_fit"]["grad_gather"])
    # the wide engine: each kernel's checks and times at the wide boxes,
    # and its launches over the box-81 fit of its configuration
    for name, key, cfg in (("monotonic_prox", "monotonic_prox_wide",
                            "default"),
                           ("prox_chain", "prox_chain_wide",
                            "packed_prox_chain"),
                           ("fused_morph_update", "fused_morph_update_wide",
                            "fuse_morph")):
        kres[name]["wide"] = dict(
            kernel={"monotonic_prox": "mono_kernel_wide",
                    "prox_chain": "chain_kernel_wide",
                    "fused_morph_update": "fused_kernel_wide"}[name],
            source="scarlet_tpu_torch/ops/csrc/wide.cu",
            launches_box_81_fit=int(b17_counts["wide"][cfg][key]),
            k1_launches_box_81_fit=int(
                b17_counts["wide"][cfg]["monotonic_prox"]),
            shapes=b17_checks["wide"][name])

    # each kernel's launches from the run of the path that drives it:
    # K1, K3 and K4 from one device-stream run, K5 and K6 from the fit of
    # their configuration
    launches = dict(stream_counts)
    launches["prox_chain"] = fused_counts["packed_prox_chain"]["prox_chain"]
    launches["fused_morph_update"] = \
        fused_counts["fuse_morph"]["fused_morph_update"]
    launches["mono_pass_variant"] = t1_launches
    launches["monotonic_prox_tol_tensor"] = \
        opt_counts["schedule"]["monotonic_prox_tol_tensor"]
    path = dict(prox_chain="fit, packed_prox_chain",
                fused_morph_update="fit, fuse_morph",
                mono_pass_variant="tools.mono_pass_attrib",
                monotonic_prox_tol_tensor="device stream, mono_tol_early/"
                "mono_tol_switch")
    # no one PyTorch call computes any of them (PERF.md): library_ms null
    main_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name], launches=int(launches[name]),
             **{k: res[k] for k in main_keys}, library_ms=None,
             path=path.get(name, "device stream"),
             launches_host_path=int(host_counts.get(name, 0)),
             **{k: v for k, v in res.items() if k not in main_keys})
        for name, res in kres.items()]
    log(f"CPU rerun max rel logL diff {cpu_rel:.3g}")
    log(f"chip_smoke total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
