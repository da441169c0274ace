"""The Hopper kernels of the lite fit loop and their plain PyTorch
versions.

======================  ===================  ================================
wrapper                 CUDA source          TPU kernel it replaces
======================  ===================  ================================
monotonic_prox          csrc/mono.cu,        ``batched_monotonic_prox`` (K1)
                        csrc/wide.cu
monotonic_prox_packed   the same, through    ``monotonic_prox_packed`` (K2)
                        strides
prox_chain              csrc/mono.cu,        ``monotonic_prox_packed_chain``
                        csrc/wide.cu         (K5)
fused_morph_update      csrc/mono.cu,        ``fused_morph_update`` (K6)
                        csrc/wide.cu
scene_assembly          csrc/scene.cu        ``scene_assembly`` (K3)
grad_gather             csrc/grad.cu         ``grad_gather`` (K4)
mono_pass_variant       csrc/attrib.cu       ``tools/mono_pass_attrib.py``
                                             ``make_kernel`` (T1)
======================  ===================  ================================

(TPU kernels K1-K6: ``scarlet_tpu/ops/pallas_kernels.py``.)  Boxes that
:func:`mono_geometry` takes (up to 73 pixels a side) run the register
kernels of ``csrc/mono.cu``, one block per morphology; larger boxes run
the wide engine of ``csrc/wide.cu`` (``mono_kernel_wide``,
``chain_kernel_wide``, ``fused_kernel_wide``), which spreads each
morphology over a thread-block cluster (:func:`wide_geometry`).  Either
way one call is one launch.

Each wrapper takes a leading batch axis (any number of leading dims) and:

* on CPU tensors, runs its plain version (``*_plain``, written from the
  JAX package's XLA branch of the engine);
* on CUDA tensors, checks device, dtype, shape and layout, allocates the
  output with ``torch.empty``, launches the kernel on the current stream,
  raises if the launch failed, and adds one to its ``launches`` count.
  There is no fallback to the plain version on the card.

No ``torch.autograd.Function`` is needed: the fit's gradients are
analytic (the residual convolved with the flipped kernel, then contracted
per component by :func:`grad_gather`), so nothing differentiates through
these kernels.

Layout: the port keeps morphologies as (..., K, hb, wb).  The JAX
package's lane-packed (hb, K*wb) layout is a TPU device; here it exists
only as :func:`monotonic_prox_packed`, which runs the same kernel through
strides.  The TPU's K5 writes its output onto its ``x_orig`` input
buffer; :func:`prox_chain` writes a fresh tensor.
"""
from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .prox import NEIGHBOR_OFFSETS, shift_zero
from ..optim import AdaproxState

__all__ = [
    "MONO_UNROLL",
    "monotonic_prox",
    "monotonic_prox_packed",
    "candidate_index",
    "prox_chain",
    "fused_morph_update",
    "scene_assembly",
    "SceneGeometry",
    "scene_geometry",
    "grad_gather",
    "GradGeometry",
    "grad_geometry",
    "gather_kernel_info",
    "MONO_PASS_MIXES",
    "mono_pass_variant",
    "mono_pass_variant_taps",
    "monotonic_prox_plain",
    "MonoTaps",
    "mono_taps",
    "monotonic_prox_taps_plain",
    "MonoGeometry",
    "mono_geometry",
    "WideGeometry",
    "wide_geometry",
    "mono_wide_workspace",
    "mono_kernel_info",
    "wide_kernel_info",
    "monotonic_prox_packed_plain",
    "prox_chain_plain",
    "fused_morph_update_plain",
    "scene_assembly_plain",
    "grad_gather_plain",
    "mono_pass_variant_plain",
    "launch_counts",
    "reset_launch_counts",
]

# Jacobi passes per convergence test, as in the TPU kernel: exits fall on
# the same 4-pass boundaries, so records match at mono_tol > 0
MONO_UNROLL = 4


def _check(name, err):
    if err != 0:
        msg = build.load().scarlet_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: no kernel for device {t.device}")


def _f32(name, t, what):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _is_cpu(*tensors):
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if any(t.device.type == "cpu" for t in tensors):
        raise ValueError("tensors on mixed devices")
    return False


# ---------------------------------------------------------------------------
# K1/K2: monotonicity projection
# ---------------------------------------------------------------------------
def _mono_pass(x, x0, w, keep, scale):
    # one zero border, then each neighbour is a view of it: the values of
    # shift_zero(x, dy, dx), with one pad per pass instead of eight
    H, W = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1))
    ref = torch.zeros_like(x)
    for d, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        ref = ref + w[..., d, :, :] * padded[..., 1 + dy:1 + dy + H,
                                             1 + dx:1 + dx + W]
    return torch.where(keep, x0, torch.minimum(x0, ref * scale))


def _block_changed(new, x, tol):
    """Per morphology of (..., K, hb, wb): whether the block's last pass
    moved a pixel by more than ``tol`` (``tol > 0``) or changed one
    (``tol == 0``).  ``tol`` is a float or a tensor of the leading
    (blend) shape ``new.shape[:-3]``, one tolerance per blend."""
    if isinstance(tol, torch.Tensor):
        t = tol[..., None]                       # per blend -> per morph
        moved = (new - x).abs().amax(dim=(-2, -1)) > t
        return torch.where(t > 0, moved, (new != x).any(dim=-1).any(dim=-1))
    if tol > 0.0:
        return (new - x).abs().amax(dim=(-2, -1)) > tol
    return (new != x).any(dim=-1).any(dim=-1)


def _mono_blocks(morphs, n_iter, tol, one_pass):
    """The kernel's exit rule around ``one_pass(x)``: Jacobi passes in
    blocks of ``MONO_UNROLL``; a morphology stops after the block whose
    last pass changed nothing (``tol == 0``) or moved no pixel by more
    than ``tol``, or once ``n_iter`` passes have run.  ``tol``: a float,
    or one per blend (:func:`_block_changed`)."""
    x = morphs
    running = torch.ones(morphs.shape[:-2], dtype=torch.bool,
                         device=morphs.device)
    t = 0
    while t < n_iter and bool(running.any()):
        start = x
        for _ in range(MONO_UNROLL - 1):
            x = one_pass(x)
        new = one_pass(x)
        changed = _block_changed(new, x, tol)
        x = torch.where(running[..., None, None], new, start)
        running = running & changed
        t += MONO_UNROLL
    return x


def monotonic_prox_plain(morphs, idx, weights_table, keep_table, n_iter,
                         min_gradient=0.0, tol=0.0):
    """Plain version of :func:`monotonic_prox` (engine.py:635-647 of the
    JAX package, with the kernel's exit rule, :func:`_mono_blocks`).  At
    ``tol == 0`` this is the exact fixed point, equal to ``n_iter`` plain
    passes.

    Every pass sums all 8 weighted neighbours, zero weights included.  The
    kernel sums only the nonzero taps (:func:`mono_taps`), which gives the
    same bits for finite morphologies; where a neighbour with weight 0 is
    inf or NaN, ``0 * inf`` makes this version's pixel NaN and the
    kernel's stays finite (:func:`monotonic_prox_taps_plain` is the
    kernel's arithmetic)."""
    idx = idx.long()
    w = weights_table[idx]                   # (..., K, 8, hb, wb)
    keep = keep_table[idx] > 0.5             # (..., K, hb, wb)
    scale = 1.0 - min_gradient
    return _mono_blocks(morphs, n_iter, tol,
                        lambda x: _mono_pass(x, morphs, w, keep, scale))


class MonoTaps(NamedTuple):
    """The nonzero taps of a monotonicity table (:func:`mono_taps`)."""
    weights: np.ndarray   # (ncand, hb, wb, T) float32, d order, 0-padded
    codes: np.ndarray     # (ncand, hb, wb) int32: count | d_t << 4 + 3t
    centers: np.ndarray   # (ncand,) int32: flat index of the keep pixel
    T: int


def mono_taps(weights_table, keep_table, T=None):
    """The compact form of monotonicity tables that the kernel reads: per
    candidate and pixel, the nonzero weights in ``d`` order (up to ``T``,
    zero-padded) and one int32 with their count (bits 0-3) and directions
    (3 bits each from bit 4); per candidate, the flat index of its one
    keep pixel.

    weights_table (ncand, 8, hb, wb), keep_table (ncand, hb, wb), numpy.
    ``T``: 4 or 8 (default: 4 where every pixel has at most 4 nonzero
    taps, as the "angle", "flat" and "nearest" tables do).  Raises
    ValueError for a pixel with more than ``T`` taps, or a candidate
    without exactly one keep pixel."""
    w = np.asarray(weights_table, np.float32)
    keep = np.asarray(keep_table) > 0.5
    ncand, _, hb, wb = w.shape
    nz = w != 0
    count = nz.sum(axis=1)
    most = int(count.max()) if count.size else 0
    if T is None:
        T = 4 if most <= 4 else 8
    if T not in (4, 8):
        raise ValueError(f"mono_taps: T must be 4 or 8, got {T}")
    if most > T:
        raise ValueError(f"mono_taps: a pixel has {most} nonzero taps, "
                         f"more than T={T}")
    n_keep = keep.reshape(ncand, -1).sum(axis=1)
    if keep.shape != (ncand, hb, wb) or (n_keep != 1).any():
        raise ValueError("mono_taps: each candidate needs exactly one keep "
                         f"pixel (counts {n_keep.tolist()})")
    taps = np.zeros((ncand, hb, wb, T), np.float32)
    codes = count.astype(np.int64)
    slot = np.cumsum(nz, axis=1) - 1          # tap index of each nonzero d
    for d in range(8):
        for t in range(T):
            sel = nz[:, d] & (slot[:, d] == t)
            taps[..., t][sel] = w[:, d][sel]
            codes[sel] |= d << (4 + 3 * t)
    centers = keep.reshape(ncand, -1).argmax(axis=1).astype(np.int32)
    return MonoTaps(taps, codes.astype(np.int32), centers, T)


def monotonic_prox_taps_plain(morphs, idx, taps, n_iter, min_gradient=0.0,
                              tol=0.0):
    """:func:`monotonic_prox_plain` on the compact table ``taps``
    (:class:`MonoTaps`, numpy or tensors): each pass sums only a pixel's
    nonzero taps, in ``d`` order, as the kernel does.  Equal to
    :func:`monotonic_prox_plain` bit for bit for finite morphologies."""
    dev = morphs.device
    idx = idx.long()
    w = torch.as_tensor(taps.weights, device=dev)[idx]    # (..., hb, wb, T)
    codes = torch.as_tensor(taps.codes, device=dev)[idx].long()
    cen = torch.as_tensor(taps.centers, device=dev)[idx].long()
    hb, wb = morphs.shape[-2:]
    keep = torch.arange(hb * wb, device=dev).reshape(hb, wb) \
        == cen[..., None, None]
    count = codes & 15
    dirs = [(codes >> (4 + 3 * t)) & 7 for t in range(taps.T)]
    scale = 1.0 - min_gradient

    def one_pass(x):
        nb = torch.stack([shift_zero(x, dy, dx)
                          for dy, dx in NEIGHBOR_OFFSETS], dim=-1)
        ref = torch.zeros_like(x)
        for t, d in enumerate(dirs):
            term = w[..., t] * nb.gather(-1, d[..., None])[..., 0]
            ref = torch.where(t < count, ref + term, ref)
        return torch.where(keep, morphs, torch.minimum(morphs, ref * scale))

    return _mono_blocks(morphs, n_iter, tol, one_pass)


# thread slots per pixel strip that the kernels are built for (csrc/mono.cu)
MONO_SLOTS = (4, 8, 12)
MONO_MAX_THREADS = 512
SMEM_LIMIT = 232448       # bytes of shared memory a block can use (H100)


class MonoGeometry(NamedTuple):
    """How a projection block covers one (hb, wb) morphology: in the
    frame (the box, transposed when it is wider than tall) the block's
    thread ``i`` takes column ``i % W`` and, for ``i // W < ny``, rows
    ``i // W + j * ny`` for ``j < P``, those below H."""
    transposed: bool
    H: int            # frame rows
    W: int            # frame columns (at most 73)
    ny: int           # row strips
    P: int            # slots per thread (a kernel template parameter)
    threads: int      # a whole number of warps, at most MONO_MAX_THREADS
    smem: int         # bytes: zero-bordered cur and next, and x0


def mono_geometry(hb, wb):
    """The launch geometry of the projection kernels for an (hb, wb)
    box; raises ValueError for a box they cannot take."""
    tr = wb > hb
    H, W = (wb, hb) if tr else (hb, wb)
    smem = 3 * (H + 2) * (W + 2) * 4
    for P in MONO_SLOTS:
        ny = -(-H // P)
        threads = -(-W * ny // 32) * 32
        if threads <= MONO_MAX_THREADS and smem <= SMEM_LIMIT:
            return MonoGeometry(tr, H, W, ny, P, threads, smem)
    raise ValueError(f"box ({hb}, {wb}) does not fit the projection "
                     f"kernels ({MONO_MAX_THREADS} threads of at most "
                     f"{MONO_SLOTS[-1]} pixels, {smem} B of shared memory)")


# The wide engine (csrc/wide.cu): slots per thread of its register route
# and the block size each instantiation is compiled for; the block of its
# streamed route (taps read each pass); cluster sizes
WIDE_SLOTS = (1, 2, 4, 8, 12)
WIDE_SLOT_THREADS = (1024, 1024, 1024, 640, 512)
WIDE_STREAM_THREADS = 1024
WIDE_CLUSTERS = (1, 2, 4, 8, 16)    # past 8: a non-portable cluster size
# a band's planes leave room for the kernels' static shared memory
WIDE_SMEM_LIMIT = SMEM_LIMIT - 1024


class WideGeometry(NamedTuple):
    """How the wide engine covers one (hb, wb) morphology: the frame (the
    box, transposed when it is wider than tall) is cut into ``R`` bands of
    whole rows, band ``r`` rows ``[r H // R, (r + 1) H // R)``, one CTA
    each, the R CTAs one thread-block cluster.  Each CTA keeps its band's
    three zero-bordered planes (cur, next, x0), with one halo row above
    and below, in its shared memory, or with ``workspace`` in device
    memory."""
    transposed: bool
    H: int            # frame rows
    W: int            # frame columns
    R: int            # CTAs per morphology (the cluster size)
    rows: int         # rows of the largest band
    P: int            # slots per thread, taps in registers; 0: streamed
    ny: int           # row strips of a band (register route; else 0)
    threads: int
    smem: int         # dynamic shared bytes per CTA (0 with workspace)
    workspace: bool   # the planes in device memory (past 16 CTAs' room)

    def bands(self):
        """Each CTA's frame rows, ``[(start, stop), ...]`` by rank."""
        return [(r * self.H // self.R, (r + 1) * self.H // self.R)
                for r in range(self.R)]


def _band_bytes(rows, W):
    return 3 * (rows + 2) * (W + 2) * 4


def _band_slots(rows, W):
    """(P, ny, threads) of the register route for a band of rows x W: the
    fewest slots whose block fits its instantiation; None if none does."""
    for P, most in zip(WIDE_SLOTS, WIDE_SLOT_THREADS):
        ny = -(-rows // P)
        threads = -(-W * ny // 32) * 32
        if threads <= most:
            return P, ny, threads
    return None


def wide_geometry(n_morphs, hb, wb, sms, resident=None):
    """The wide engine's launch geometry for ``n_morphs`` (hb, wb)
    morphologies on a card of ``sms`` SMs.

    R, a power of two in :data:`WIDE_CLUSTERS` (16 past the portable 8:
    the kernels set ``cudaFuncAttributeNonPortableClusterSizeAllowed``)
    and at most the frame's rows, is the larger of
      * the most CTAs per morphology whose ``n_morphs`` clusters the card
        holds at once: ``resident[R]`` clusters of R one-SM CTAs (on the
        card, :func:`_card`; by default ``sms // R``), 1 once the
        morphologies fill the SMs, and
      * the fewest whose band fits a block: its three planes in shared
        memory (``WIDE_SMEM_LIMIT``) and its pixels in the register slots
        (:data:`WIDE_SLOTS`: a thread takes one frame column and every
        ny-th row, as :func:`mono_geometry`); where no R up to 16 gives
        register slots, the fewest whose planes fit (the band streams its
        taps, ``P = 0``).  On an H100 the register route at R = 2 took
        half the time of one streaming block per morphology at 512
        morphologies of 81 px (PERF.md, PR 17).
    Where no band of 16 CTAs fits shared memory, the planes go to a
    device-memory workspace, the taps stream and R is the first rule's."""
    tr = wb > hb
    H, W = (wb, hb) if tr else (hb, wb)
    sizes = [R for R in WIDE_CLUSTERS if R <= H]
    fits = [R for R in sizes if _band_bytes(-(-H // R), W) <= WIDE_SMEM_LIMIT]
    slotted = [R for R in fits if _band_slots(-(-H // R), W)]
    held = resident or {}
    fill = max(R for R in sizes
               if R == 1 or n_morphs <= held.get(R, sms // R))
    R = max(fill, (slotted or fits)[0]) if fits else fill
    rows = -(-H // R)
    slots = None if not fits else _band_slots(rows, W)
    P, ny, threads = slots or (0, 0, WIDE_STREAM_THREADS)
    return WideGeometry(tr, H, W, R, rows, P, ny, threads,
                        _band_bytes(rows, W) if fits else 0, not fits)


def mono_wide_workspace(hb, wb):
    """Whether the wide engine keeps an (hb, wb) box's planes in a
    device-memory workspace (``3 (rows+2) (W+2)`` floats per CTA) because
    even 16 CTAs' shared memory cannot hold them
    (square boxes past 533 pixels a side)."""
    return wide_geometry(1, hb, wb, WIDE_CLUSTERS[-1]).workspace


@functools.lru_cache(maxsize=None)
def _card(index):
    """(SMs, {R: clusters of R one-SM CTAs resident at once}) of CUDA
    device ``index``, read once: the clusters from
    ``cudaOccupancyMaxActiveClusters`` on the wide engine's 1024-thread
    kernel (one CTA an SM); an H100's GPCs hold fewer clusters of 16 than
    132 // 16."""
    import ctypes

    lib = build.load()
    resident = {}
    with torch.cuda.device(index):
        for R in WIDE_CLUSTERS[1:]:
            vals = (ctypes.c_int * 4)()
            _check("wide_geometry", lib.scarlet_wide_kernel_info(
                0, 4, 1, R, WIDE_SLOT_THREADS[0], 0, vals))
            resident[R] = vals[3]
    return torch.cuda.get_device_properties(index).multi_processor_count, \
        resident


def _card_geometry(device, n_morphs, hb, wb):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return wide_geometry(n_morphs, hb, wb, *_card(index))


def _wide_setup(x, n_morphs, hb, wb):
    """The geometry of a wide launch on ``x``'s device and its workspace
    (a tensor, or None)."""
    geo = _card_geometry(x.device, n_morphs, hb, wb)
    work = torch.empty(n_morphs * geo.R * 3 * (geo.rows + 2) * (geo.W + 2),
                       dtype=torch.float32, device=x.device) \
        if geo.workspace else None
    return geo, work


def _wide_args(taps, geo, work):
    """The arguments that end each wide entry point, before the stream."""
    return (taps.T, geo.P, geo.ny, int(geo.transposed), geo.R, geo.rows,
            geo.threads, geo.smem, 0 if work is None else work.data_ptr())


# device copies of the compact tables, per table tensor (built once)
_TAPS = {}


def _device_taps(weights_table, keep_table, make=mono_taps):
    """``make`` (:func:`mono_taps`) of two table tensors, on their device:
    built on the host the first time a table is seen (one device-to-host
    copy), then kept while the table tensor lives and is not written to."""
    key = (id(weights_table), id(keep_table), make)
    version = (weights_table._version, keep_table._version)
    hit = _TAPS.get(key)
    if hit is not None and hit[0]() is weights_table \
            and hit[1]() is keep_table and hit[2] == version:
        return hit[3]
    taps = make(weights_table.cpu().numpy(), keep_table.cpu().numpy())
    dev = weights_table.device
    # C order: the kernels index the taps as contiguous arrays, and a
    # table read through a view can give them another layout
    on_dev = MonoTaps(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in taps[:3]), taps.T)
    _TAPS[key] = (weakref.ref(weights_table), weakref.ref(keep_table),
                  version, on_dev)
    weakref.finalize(weights_table, _TAPS.pop, key, None)
    return on_dev


def monotonic_prox(morphs, idx, weights_table, keep_table, n_iter,
                   min_gradient=0.0, tol=0.0):
    """Radially monotonic projection of a stack of morphologies.

    morphs: (..., K, hb, wb) float32; idx: (..., K) integer table index
    (candidate center) per morphology; weights_table: (ncand, 8, hb, wb);
    keep_table: (ncand, hb, wb), 1.0 at the never-updated center;
    n_iter: the DAG depth (``monotonic_depth``); tol: the exit tolerance
    (0 = exact), a float or a float32 tensor of one value per blend
    (shape ``morphs.shape[:-3]``, ``()`` for one blend) on the morphs'
    device, which the kernel reads there: a schedule of tolerances needs
    no host read (the TPU kernel's ``tol_arr``).

    Exits per morphology (the TPU kernel exits per group of lane-packed
    morphologies; the two agree exactly at ``tol == 0`` and with a group
    of one at ``tol > 0``).

    On the card the kernel reads the tables' nonzero taps
    (:func:`mono_taps`, built on the host once per table tensor), so each
    candidate needs exactly one keep pixel, and a neighbour with weight 0
    is never read (inf/NaN: :func:`monotonic_prox_plain`).  Boxes that
    :func:`mono_geometry` takes (up to 73 pixels a side) run
    ``mono_kernel``, with the taps in registers; larger boxes run the wide
    engine's ``mono_kernel_wide`` (:func:`wide_geometry`), which gives the
    same bits at any size.
    """
    _check_tol("monotonic_prox", tol, morphs.shape[:-3])
    if _is_cpu(morphs, idx, weights_table, keep_table, *_tol_tensor(tol)):
        return monotonic_prox_plain(morphs, idx, weights_table, keep_table,
                                    n_iter, min_gradient, tol)
    K, hb, wb = morphs.shape[-3:]
    if idx.shape != morphs.shape[:-2]:
        raise ValueError(f"monotonic_prox: idx {tuple(idx.shape)} does not "
                         f"match morphs {tuple(morphs.shape)}")
    _f32("monotonic_prox", morphs, "morphs")
    strides = (K * hb * wb, hb * wb, wb, 1)
    return _mono_launch("monotonic_prox", morphs, idx, weights_table,
                        keep_table, K, hb, wb, strides, n_iter, min_gradient,
                        tol)


def monotonic_prox_packed_plain(packed, idx, weights_table, keep_table, wb,
                                n_iter, min_gradient=0.0, tol=0.0):
    """Plain version of :func:`monotonic_prox_packed`."""
    hb, gW = packed.shape[-2:]
    K = gW // wb
    view = packed.reshape(*packed.shape[:-1], K, wb).movedim(-2, -3)
    out = monotonic_prox_plain(view, idx, weights_table, keep_table, n_iter,
                               min_gradient, tol)
    return out.movedim(-3, -2).reshape(packed.shape)


def monotonic_prox_packed(packed, idx, weights_table, keep_table, wb,
                          n_iter, min_gradient=0.0, tol=0.0):
    """:func:`monotonic_prox` on the lane-packed (..., hb, K*wb) layout
    (slot k in columns [k*wb, (k+1)*wb)), read and written in place by
    strides: no pack/unpack copies."""
    _check_tol("monotonic_prox_packed", tol, packed.shape[:-2])
    if _is_cpu(packed, idx, weights_table, keep_table, *_tol_tensor(tol)):
        return monotonic_prox_packed_plain(packed, idx, weights_table,
                                           keep_table, wb, n_iter,
                                           min_gradient, tol)
    hb, gW = packed.shape[-2:]
    if gW % wb:
        raise ValueError(f"monotonic_prox_packed: width {gW} is not a "
                         f"multiple of wb={wb}")
    K = gW // wb
    if idx.shape != (*packed.shape[:-2], K):
        raise ValueError(f"monotonic_prox_packed: idx {tuple(idx.shape)} "
                         f"does not match {K} slots")
    _f32("monotonic_prox_packed", packed, "packed")
    strides = (hb * gW, wb, gW, 1)
    return _mono_launch("monotonic_prox_packed", packed, idx, weights_table,
                        keep_table, K, hb, wb, strides, n_iter, min_gradient,
                        tol)


def _tables_lib(name, weights_table, keep_table, hb, wb, wide=False):
    """Check the monotonicity tables and the box; returns (library,
    ncand, the tables' taps on the device, the launch geometry).  With
    ``wide``, a box beyond :func:`mono_geometry` gives the geometry
    ``None`` (the wide engine) instead of raising."""
    _f32(name, weights_table, "weights_table")
    _f32(name, keep_table, "keep_table")
    ncand = weights_table.shape[0]
    if (tuple(weights_table.shape) != (ncand, 8, hb, wb)
            or tuple(keep_table.shape) != (ncand, hb, wb)):
        raise ValueError(f"{name}: tables {tuple(weights_table.shape)}, "
                         f"{tuple(keep_table.shape)} do not fit box "
                         f"({hb}, {wb})")
    try:
        geom = mono_geometry(hb, wb)
    except ValueError as e:
        if not wide:
            raise ValueError(f"{name}: {e}") from None
        geom = None
    taps = _device_taps(weights_table, keep_table)
    return build.load(), ncand, taps, geom


def _taps_args(taps, geom):
    """The kernel arguments that carry the compact tables and the
    geometry (``None``: the wide engine's, :func:`_wide_args`), after the
    table pointers' place in each entry point."""
    return ((taps.weights.data_ptr(), taps.codes.data_ptr(),
             taps.centers.data_ptr()),
            None if geom is None else
            (taps.T, geom.P, geom.ny, int(geom.transposed), geom.threads))


def _tol_tensor(tol):
    """``(tol,)`` for a tensor tolerance, else ``()``."""
    return (tol,) if isinstance(tol, torch.Tensor) else ()


def _check_tol(name, tol, lead):
    """A tensor tolerance holds one float32 value per blend (``lead``)."""
    if not isinstance(tol, torch.Tensor):
        return
    if tuple(tol.shape) != tuple(lead):
        raise ValueError(f"{name}: tol {tuple(tol.shape)} is not one value "
                         f"per blend {tuple(lead)}")
    if tol.dtype != torch.float32:
        raise TypeError(f"{name}: tol must be float32, got {tol.dtype}")


def _mono_launch(name, x, idx, weights_table, keep_table, K, hb, wb, strides,
                 n_iter, min_gradient, tol):
    _require_cuda(name, x, idx, weights_table, keep_table, *_tol_tensor(tol))
    lib, ncand, taps, geom = _tables_lib(name, weights_table, keep_table,
                                         hb, wb, wide=True)
    idx32 = idx.to(torch.int32).contiguous()
    B = x.numel() // (K * hb * wb)
    tols = tol.contiguous() if isinstance(tol, torch.Tensor) else None
    out = torch.empty_like(x)
    if B * K == 0:
        return out
    args = (x.data_ptr(), out.data_ptr(), idx32.data_ptr(),
            taps.weights.data_ptr(), taps.codes.data_ptr(),
            taps.centers.data_ptr(), ncand, B, K, hb, wb, *strides,
            int(n_iter), 1.0 - float(min_gradient),
            0.0 if tols is not None else float(tol),
            0 if tols is None else tols.data_ptr())
    with torch.cuda.device(x.device):
        if geom is not None:
            err = lib.scarlet_mono_prox(*args, *_taps_args(taps, geom)[1],
                                        _stream(x))
        else:
            wide, work = _wide_setup(x, B * K, hb, wb)
            err = lib.scarlet_wide_prox(*args, *_wide_args(taps, wide, work),
                                        _stream(x))
    _check(name, err)
    monotonic_prox.launches += 1
    if tols is not None:
        monotonic_prox.tol_tensor_launches += 1
    if geom is None:
        monotonic_prox.wide_launches += 1
    return out


monotonic_prox.launches = 0
# the launches among them that read a tolerance per blend
monotonic_prox.tol_tensor_launches = 0
# the launches among them of the wide engine's mono_kernel_wide (boxes
# beyond mono_geometry)
monotonic_prox.wide_launches = 0

_MONO_KERNELS = ("monotonic_prox", "prox_chain", "fused_morph_update")


def mono_kernel_info(hb, wb, T=4):
    """What the compiler made of the projection kernels for an (hb, wb)
    box (card only): per wrapper, the instantiation's registers per
    thread, local-memory (spill) bytes per thread, threads, dynamic shared
    bytes and the blocks resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    geom = mono_geometry(hb, wb)
    lib = build.load()
    out = {}
    for which, name in enumerate(_MONO_KERNELS):
        vals = (ctypes.c_int * 3)()
        _check(name, lib.scarlet_mono_kernel_info(
            which, T, geom.P, geom.threads, geom.smem, vals))
        out[name] = dict(registers=vals[0], spill_bytes=vals[1],
                         blocks_per_sm=vals[2], threads=geom.threads,
                         smem_bytes=geom.smem, T=T, P=geom.P)
    return out


def wide_kernel_info(n_morphs, hb, wb, T=4):
    """What the compiler made of the wide engine's kernels for
    ``n_morphs`` (hb, wb) morphologies (card only): per wrapper, the
    instantiation's registers per thread, local-memory (spill) bytes per
    thread, blocks resident per SM, clusters of R resident at once
    (``cudaOccupancyMaxActiveClusters``) and :func:`wide_geometry`."""
    import ctypes

    geo = _card_geometry(torch.device("cuda"), n_morphs, hb, wb)
    lib = build.load()
    out = {}
    for which, name in enumerate(_MONO_KERNELS):
        vals = (ctypes.c_int * 4)()
        _check(name, lib.scarlet_wide_kernel_info(
            which, T, geo.P, geo.R, geo.threads, geo.smem, vals))
        out[name] = dict(registers=vals[0], spill_bytes=vals[1],
                         blocks_per_sm=vals[2], clusters=vals[3], T=T,
                         **geo._asdict())
    return out


# ---------------------------------------------------------------------------
# K5/K6: the morphology prox chain, alone and fused with the step
# ---------------------------------------------------------------------------
def candidate_index(morphs, radius):
    """Table index of each morphology's candidate center: the first
    maximum of its (2r+1)^2 center window, row-major (``argmax``)."""
    if radius <= 0:
        return torch.zeros(morphs.shape[:-2], dtype=torch.int64,
                           device=morphs.device)
    hb, wb = morphs.shape[-2:]
    cy, cx = hb // 2, wb // 2
    win = morphs[..., cy - radius:cy + radius + 1, cx - radius:cx + radius + 1]
    return win.reshape(*win.shape[:-2], -1).argmax(dim=-1)


def chain_epilogue(x, thr, gate, x_orig, floor):
    """The prox chain after the projection: pixels below the per-slot
    cutoff ``thr`` (..., K) go to 0, the center pixel is raised to at
    least ``floor``, each morphology is divided by its max, and slots whose
    ``gate`` (..., K) is off keep ``x_orig``."""
    hb, wb = x.shape[-2:]
    x = torch.where(x < thr[..., None, None], 0.0, x)
    # fresh tensor from the where above: the in-place center write is local
    x[..., hb // 2, wb // 2] = torch.clamp_min(x[..., hb // 2, wb // 2],
                                               floor)
    x = x / x.amax(dim=(-2, -1), keepdim=True)
    return torch.where(gate[..., None, None], x, x_orig)


def prox_chain_plain(x_orig, stepped, idx, weights_table, keep_table, thr,
                     gate, n_iter, min_gradient=0.0, floor=1e-20, tol=0.0):
    """Plain version of :func:`prox_chain` (engine.py:706-730 of the JAX
    package, the packed prox chain, then the slot gate)."""
    out = monotonic_prox_plain(stepped, idx, weights_table, keep_table,
                               n_iter, min_gradient, tol)
    return chain_epilogue(out, thr.to(out.dtype), gate.to(torch.bool),
                          x_orig, floor)


def prox_chain(x_orig, stepped, idx, weights_table, keep_table, thr, gate,
               n_iter, min_gradient=0.0, floor=1e-20, tol=0.0):
    """The morphology prox chain of a stack of slots in one pass:
    :func:`monotonic_prox` of ``stepped`` (the stepped, box-masked
    morphologies), then :func:`chain_epilogue` with ``x_orig`` (the
    morphologies before the step) for gated-off slots.

    x_orig, stepped (..., K, hb, wb) float32; idx (..., K) table index;
    thr (..., K) float per-slot cutoff ``min_c t_c / sed_c`` (0: the
    positivity clamp); gate (..., K) bool.  Returns a fresh tensor.

    A box beyond :func:`mono_geometry` (over 73 pixels a side) runs the
    wide engine's ``chain_kernel_wide`` (:func:`wide_geometry`), chosen
    from the shape: one launch, the same bits; counted in
    ``prox_chain.wide_launches``, not in ``prox_chain.launches``.
    """
    if _is_cpu(x_orig, stepped, idx, weights_table, keep_table, thr, gate):
        return prox_chain_plain(x_orig, stepped, idx, weights_table,
                                keep_table, thr, gate, n_iter, min_gradient,
                                floor, tol)
    name = "prox_chain"
    _require_cuda(name, x_orig, stepped, idx, weights_table, keep_table, thr,
                  gate)
    hb, wb = stepped.shape[-2:]
    lead = tuple(stepped.shape[:-2])
    if (tuple(x_orig.shape) != tuple(stepped.shape)
            or tuple(idx.shape) != lead or tuple(thr.shape) != lead
            or tuple(gate.shape) != lead):
        raise ValueError(f"{name}: shapes do not match: x_orig "
                         f"{tuple(x_orig.shape)}, stepped "
                         f"{tuple(stepped.shape)}, idx {tuple(idx.shape)}, "
                         f"thr {tuple(thr.shape)}, gate {tuple(gate.shape)}")
    _f32(name, x_orig, "x_orig")
    _f32(name, stepped, "stepped")
    lib, ncand, taps, geom = _tables_lib(name, weights_table, keep_table,
                                         hb, wb, wide=True)
    idx32 = idx.to(torch.int32).contiguous()
    thr32 = thr.to(torch.float32).contiguous()
    gate8 = gate.to(torch.bool).contiguous()
    out = torch.empty_like(stepped)
    N = stepped.numel() // (hb * wb) if hb * wb else 0
    if N == 0:
        return out
    tables, launch = _taps_args(taps, geom)
    args = (x_orig.data_ptr(), stepped.data_ptr(), out.data_ptr(),
            idx32.data_ptr(), thr32.data_ptr(), gate8.data_ptr(), *tables,
            ncand, N, hb, wb, int(n_iter), 1.0 - float(min_gradient),
            float(floor), float(tol))
    with torch.cuda.device(stepped.device):
        if geom is not None:
            err = lib.scarlet_prox_chain(*args, *launch, _stream(stepped))
        else:
            wide, work = _wide_setup(stepped, N, hb, wb)
            err = lib.scarlet_wide_chain(*args,
                                         *_wide_args(taps, wide, work),
                                         _stream(stepped))
    _check(name, err)
    if geom is None:
        prox_chain.wide_launches += 1
    else:
        prox_chain.launches += 1
    return out


prox_chain.launches = 0
# the launches of chain_kernel_wide (boxes beyond mono_geometry)
prox_chain.wide_launches = 0


def fused_morph_update_plain(morphs, grads, opt, gate, weights_table,
                             keep_table, box_masks, thr, damp_step, n_iter,
                             min_gradient=0.0, fit_center_radius=1, b1=0.9,
                             b2=0.999, eps=1e-8, floor=1e-20):
    """Plain version of :func:`fused_morph_update`: the engine's amsgrad
    step (``optim.adaprox_step``, same association), the box mask, the
    candidate pick, :func:`monotonic_prox_plain` at tol 0 and
    :func:`chain_epilogue`."""
    m2 = (1 - b1) * grads + b1 * opt.m
    v2 = (1 - b2) * (grads * grads) + b2 * opt.v
    vh2 = torch.maximum(opt.vhat, v2)
    ds = damp_step.to(morphs.dtype)[..., None, None, None]
    x1 = morphs - ds * m2 / (torch.sqrt(vh2) + eps)
    if box_masks is not None:
        x1 = x1 * box_masks
    idx = candidate_index(x1, fit_center_radius)
    out = monotonic_prox_plain(x1, idx, weights_table, keep_table, n_iter,
                               min_gradient, 0.0)
    gate = gate.to(torch.bool)
    x_new = chain_epilogue(out, thr.to(out.dtype), gate, morphs, floor)
    g3 = gate[..., None, None]
    return x_new, AdaproxState(m=torch.where(g3, m2, opt.m),
                               v=torch.where(g3, v2, opt.v),
                               vhat=torch.where(g3, vh2, opt.vhat))


def fused_morph_update(morphs, grads, opt, gate, weights_table, keep_table,
                       box_masks, thr, damp_step, n_iter, min_gradient=0.0,
                       fit_center_radius=1, b1=0.9, b2=0.999, eps=1e-8,
                       floor=1e-20):
    """The whole amsgrad morphology update of a stack of slots in one
    pass: moments, the step ``x - ds m' / (sqrt(vhat') + eps)``, the box
    mask, the candidate pick, the monotonicity projection to its exact
    fixed point (the configured ``mono_tol`` does not apply, as in the TPU
    kernel) and :func:`chain_epilogue`; x and the moments keep their
    inputs where ``gate`` is off.

    morphs, grads, opt.{m, v, vhat}, box_masks (or None) (..., K, hb, wb)
    float32; gate (..., K) bool; thr (..., K) float; damp_step (...) the
    morphology step of each blend (0.1 x at its first iteration).
    Returns (morphs', AdaproxState).

    A box beyond :func:`mono_geometry` (over 73 pixels a side) runs the
    wide engine's ``fused_kernel_wide`` (:func:`wide_geometry`), chosen
    from the shape: one launch, the same bits; counted in
    ``fused_morph_update.wide_launches``, not in
    ``fused_morph_update.launches``.
    """
    tensors = (morphs, grads, *opt, gate, weights_table, keep_table, thr,
               damp_step) + (() if box_masks is None else (box_masks,))
    if _is_cpu(*tensors):
        return fused_morph_update_plain(
            morphs, grads, opt, gate, weights_table, keep_table, box_masks,
            thr, damp_step, n_iter, min_gradient, fit_center_radius, b1, b2,
            eps, floor)
    name = "fused_morph_update"
    _require_cuda(name, *tensors)
    hb, wb = morphs.shape[-2:]
    lead = tuple(morphs.shape[:-3])
    K = morphs.shape[-3]
    planes = [(grads, "grads"), (opt.m, "m"), (opt.v, "v"),
              (opt.vhat, "vhat")]
    if box_masks is not None:
        planes.append((box_masks, "box_masks"))
    for t, what in [(morphs, "morphs")] + planes:
        if tuple(t.shape) != tuple(morphs.shape):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} does not "
                             f"match morphs {tuple(morphs.shape)}")
        _f32(name, t, what)
    if (tuple(gate.shape) != lead + (K,) or tuple(thr.shape) != lead + (K,)
            or tuple(damp_step.shape) != lead):
        raise ValueError(f"{name}: gate {tuple(gate.shape)}, thr "
                         f"{tuple(thr.shape)}, damp_step "
                         f"{tuple(damp_step.shape)} do not fit morphs "
                         f"{tuple(morphs.shape)}")
    r = int(fit_center_radius)
    lib, ncand, taps, geom = _tables_lib(name, weights_table, keep_table,
                                         hb, wb, wide=True)
    if ncand != (2 * r + 1) ** 2 or not 0 <= r <= min(hb, wb) // 2:
        raise ValueError(f"{name}: {ncand} tables for radius {r}")
    thr32 = thr.to(torch.float32).contiguous()
    gate8 = gate.to(torch.bool).contiguous()
    ds = damp_step.to(torch.float32).contiguous()
    outs = [torch.empty_like(morphs) for _ in range(4)]
    B = ds.numel()
    if B * K == 0:
        return outs[0], AdaproxState(*outs[1:])
    bm = 0 if box_masks is None else box_masks.data_ptr()
    tables, launch = _taps_args(taps, geom)
    args = (morphs.data_ptr(), grads.data_ptr(), opt.m.data_ptr(),
            opt.v.data_ptr(), opt.vhat.data_ptr(), bm, thr32.data_ptr(),
            gate8.data_ptr(), ds.data_ptr(), *tables, ncand, B, K, hb, wb,
            int(n_iter), 1.0 - float(min_gradient), r, 1.0 - b1, b1,
            1.0 - b2, b2, eps, floor, *(o.data_ptr() for o in outs))
    with torch.cuda.device(morphs.device):
        if geom is not None:
            err = lib.scarlet_fused_morph(*args, *launch, _stream(morphs))
        else:
            wide, work = _wide_setup(morphs, B * K, hb, wb)
            err = lib.scarlet_wide_fused(*args,
                                         *_wide_args(taps, wide, work),
                                         _stream(morphs))
    _check(name, err)
    if geom is None:
        fused_morph_update.wide_launches += 1
    else:
        fused_morph_update.launches += 1
    return outs[0], AdaproxState(*outs[1:])


fused_morph_update.launches = 0
# the launches of fused_kernel_wide (boxes beyond mono_geometry)
fused_morph_update.wide_launches = 0


# ---------------------------------------------------------------------------
# T1: microkernel variants of the monotonicity pass (cost attribution)
# ---------------------------------------------------------------------------
# instruction mixes, in the kernel's numbering (csrc/mono.cuh, PassMix)
MONO_PASS_MIXES = ("full", "noreduce", "unroll8", "norolls", "rollsonly",
                   "alu8", "bf16")


def _variant_passes(mix, n_passes):
    """The pass count a variant runs for ``n_passes``: whole blocks of its
    unroll (8 for ``unroll8``, else 4)."""
    if mix not in MONO_PASS_MIXES:
        raise ValueError(f"unknown mix {mix!r}; one of {MONO_PASS_MIXES}")
    unroll = 8 if mix == "unroll8" else MONO_UNROLL
    return -(-int(n_passes) // unroll) * unroll


def _round_bf16(x):
    """float64 -> the nearest bfloat16 value (ties to even), as float64:
    one rounding of the exact value, as Hopper's bf16x2 instructions round
    (PyTorch's bf16 operations round a float32 result, a double rounding
    in rare sums).  Normal range only."""
    bits = x.view(torch.int64)
    bits = (bits + ((1 << 44) - 1) + ((bits >> 45) & 1)) & -(1 << 45)
    return bits.view(torch.float64)


def _slots(t, wb):
    """(..., hb, K*wb) lane-packed -> (..., K, hb, wb) view."""
    return t.reshape(*t.shape[:-1], t.shape[-1] // wb, wb).movedim(-2, -3)


def mono_pass_variant_plain(packed, wsel, keepsel, mix, n_passes):
    """Plain version of :func:`mono_pass_variant`: the same passes as
    tensor operations on each (hb, hb) slot, zero outside the slot.
    ``bf16`` computes each product and sum in float64 (exact for bf16
    operands) and rounds it once to bf16."""
    hb = packed.shape[-2]
    n = _variant_passes(mix, n_passes)
    x0 = _slots(packed, hb)                       # (B, K, hb, hb)
    w = _slots(wsel, hb).transpose(0, 1)          # (K, 8, hb, hb)
    keep = _slots(keepsel, hb) > 0.5              # (K, hb, hb)
    if mix == "bf16":
        x0, w = _round_bf16(x0.double()), _round_bf16(w.double())
    x = x0
    for _ in range(n):
        if mix == "rollsonly":
            x = (shift_zero(x, -1, 0) + shift_zero(x, 1, 0)
                 + shift_zero(x, 0, -1) + shift_zero(x, 0, 1)) * 0.25
        elif mix == "alu8":
            for d in range(8):
                x = x * 0.5 + w[:, d]
        elif mix == "norolls":
            ref = torch.zeros_like(x)
            for d in range(8):
                ref = ref + w[:, d] * x
            x = torch.where(keep, x0, torch.minimum(x0, ref))
        elif mix == "bf16":
            ref = torch.zeros_like(x)
            for d in range(8):
                ref = _round_bf16(ref + _round_bf16(w[:, d] * x))
            x = torch.where(keep, x0, torch.minimum(x0, ref))
        else:
            x = _mono_pass(x, x0, w, keep, 1.0)
    return x.to(packed.dtype).movedim(-3, -2).reshape(packed.shape)


def _slot_tables(wsel, keepsel):
    """Each slot's tables of the lane-packed (8, hb, K*hb), (hb, K*hb)
    numpy tables as candidates: (K, 8, hb, hb), (K, hb, hb)."""
    w = np.asarray(wsel, np.float32)
    keep = np.asarray(keepsel, np.float32)
    hb = w.shape[-2]
    K = w.shape[-1] // hb
    return (w.reshape(8, hb, K, hb).transpose(2, 0, 1, 3),
            keep.reshape(hb, K, hb).transpose(1, 0, 2))


def _variant_taps(wsel, keepsel):
    """Every mix but ``alu8``: :func:`mono_taps` of the slots' tables,
    slot k as candidate k."""
    wtab, ktab = _slot_tables(wsel, keepsel)
    n_keep = (ktab > 0.5).reshape(len(ktab), -1).sum(axis=1)
    if (n_keep != 1).any():
        raise ValueError("mono_pass_variant: the kernel keeps one pixel a "
                         "slot, as K1's tables do; keepsel has "
                         f"{n_keep.tolist()} keep pixels by slot")
    return mono_taps(wtab, ktab)


def _variant_taps_dense(wsel, keepsel):
    """``alu8``: all 8 weights of every pixel, zeros included, as taps of
    every direction in ``d`` order (T = 8)."""
    taps = _variant_taps(wsel, keepsel)
    wtab, _ = _slot_tables(wsel, keepsel)
    codes = 8 + sum(d << (4 + 3 * d) for d in range(8))
    return MonoTaps(np.ascontiguousarray(wtab.transpose(0, 2, 3, 1)),
                    np.full(taps.codes.shape, codes, np.int32),
                    taps.centers, 8)


def mono_pass_variant_taps(wsel, keepsel, mix):
    """The taps (:class:`MonoTaps`, numpy) that :func:`mono_pass_variant`'s
    kernel reads for the slot tables ``wsel`` (8, hb, K*hb) and
    ``keepsel`` (hb, K*hb): slot k's tables as candidate k of
    :func:`mono_taps`, or for ``alu8`` all 8 weights of each pixel.  Raises
    ValueError for a slot without exactly one keep pixel."""
    return _variant_maker(mix)(wsel, keepsel)


def _variant_maker(mix):
    _variant_passes(mix, 0)         # a known mix
    return _variant_taps_dense if mix == "alu8" else _variant_taps


def mono_pass_variant(packed, wsel, keepsel, mix, n_passes):
    """One instruction mix of the monotonicity pass, run for a forced pass
    count: the microkernels of the TPU tool ``tools/mono_pass_attrib.py``
    on Hopper (csrc/attrib.cu), each K1's pass (csrc/mono.cu) less the
    part it ablates.

    packed (B, hb, K*hb) float32, slot k in columns [k*hb, (k+1)*hb)
    (square boxes that :func:`mono_geometry` takes); wsel (8, hb, K*hb)
    and keepsel (hb, K*hb): each slot's weight and keep tables, unshifted,
    with one keep pixel a slot (else ValueError on the card); mix: one of
    :data:`MONO_PASS_MIXES`; n_passes: rounded up to whole blocks of the
    mix's unroll.  The convergence test of the reducing mixes never
    exits.  Returns a fresh (B, hb, K*hb) tensor.

    On the card the kernel reads the slots' taps
    (:func:`mono_pass_variant_taps`, built on the host once per table
    tensor) and runs with K1's launch geometry, ``mono_geometry(hb, hb)``.
    """
    if _is_cpu(packed, wsel, keepsel):
        return mono_pass_variant_plain(packed, wsel, keepsel, mix, n_passes)
    name = "mono_pass_variant"
    _require_cuda(name, packed, wsel, keepsel)
    n = _variant_passes(mix, n_passes)
    B, hb, gw = packed.shape
    if gw % hb or tuple(wsel.shape) != (8, hb, gw) \
            or tuple(keepsel.shape) != (hb, gw):
        raise ValueError(f"{name}: packed {tuple(packed.shape)}, wsel "
                         f"{tuple(wsel.shape)}, keepsel "
                         f"{tuple(keepsel.shape)} do not fit square slots "
                         f"of {hb}")
    for t, what in ((packed, "packed"), (wsel, "wsel"), (keepsel, "keepsel")):
        _f32(name, t, what)
    try:
        geom = mono_geometry(hb, hb)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    out = torch.empty_like(packed)
    if out.numel() == 0:
        return out
    taps = _device_taps(wsel, keepsel, _variant_maker(mix))
    with torch.cuda.device(packed.device):
        err = build.load().scarlet_mono_pass_variant(
            packed.data_ptr(), out.data_ptr(), taps.weights.data_ptr(),
            taps.codes.data_ptr(), taps.centers.data_ptr(), B, gw // hb, hb,
            MONO_PASS_MIXES.index(mix), n, taps.T, geom.P, geom.ny,
            int(geom.transposed), geom.threads, _stream(packed))
    _check(name, err)
    mono_pass_variant.launches += 1
    return out


mono_pass_variant.launches = 0


# ---------------------------------------------------------------------------
# K3: scene assembly
# ---------------------------------------------------------------------------
def _check_pad(origins, box, hw, pad):
    """The plain scene assembly adds into a scene padded by ``pad``: every
    box must fit inside it (a negative index would wrap around
    silently)."""
    hb, wb = box
    H, W = hw
    oy, ox = origins[..., 0], origins[..., 1]
    if origins.numel() and (
            int(oy.min()) + pad < 0 or int(ox.min()) + pad < 0
            or int(oy.max()) + hb > H + pad or int(ox.max()) + wb > W + pad):
        raise ValueError(f"component boxes overhang the scene by more than "
                         f"the padding {pad}")


def _windows(origins, pad, hb, wb):
    """Row and column index grids (B, hb, 1), (B, 1, wb) of each blend's
    box ``k`` inside the padded scene."""
    dev = origins.device
    rows = (origins[:, 0] + pad)[:, None] + torch.arange(hb, device=dev)
    cols = (origins[:, 1] + pad)[:, None] + torch.arange(wb, device=dev)
    return rows[:, :, None].long(), cols[:, None, :].long()


def scene_assembly_plain(seds, morphs, origins, comp_active, scene_shape,
                         pad):
    """Plain version of :func:`scene_assembly` (engine.py:427-444 of the
    JAX package): add each component's ``(sed * morph) * active`` into a
    zero scene padded by ``pad``, in component order, then crop.

    The kernel skips inactive components, which here add ``+-0`` at the
    padding's corner: the same bits for finite inputs.  Where an inactive
    slot's sed or morphology holds inf or NaN, ``0 * inf`` makes this
    version's pixels NaN inside the parked box, and the kernel's stay as
    the active components make them (csrc/scene.cu)."""
    C, H, W = scene_shape
    K = seds.shape[-2]
    hb, wb = morphs.shape[-2:]
    lead = seds.shape[:-2]
    seds = seds.reshape(-1, K, C)
    morphs = morphs.reshape(-1, K, hb, wb)
    origins = origins.reshape(-1, K, 2)
    active = comp_active.reshape(-1, K).to(torch.bool)
    on = active.to(seds.dtype)
    # an inactive box adds nothing: park it in the padding's corner, so
    # that only active boxes must fit the padded scene
    origins = torch.where(active[..., None], origins, -pad)
    _check_pad(origins, (hb, wb), (H, W), pad)
    B = seds.shape[0]
    # channels last, so one advanced index picks a (B, hb, wb, C) window
    scene = seds.new_zeros((B, H + 2 * pad, W + 2 * pad, C))
    bi = torch.arange(B, device=seds.device)[:, None, None]
    for k in range(K):
        model = (seds[:, k, None, None, :] * morphs[:, k, :, :, None]) \
            * on[:, k, None, None, None]
        rows, cols = _windows(origins[:, k], pad, hb, wb)
        scene[bi, rows, cols] = scene[bi, rows, cols] + model
    out = scene[:, pad:pad + H, pad:pad + W].permute(0, 3, 1, 2)
    return out.reshape(*lead, C, H, W)


SCENE_BANDS = 8           # bands a thread sums (csrc/scene.cu kBands)
SCENE_THREADS = 512       # most threads of a staged-walk block
SCENE_DIRECT_THREADS = 128  # most threads of a direct-walk block
SCENE_PIXEL_THREADS = 64  # pixel threads of a band group's set, or 2x
SCENE_CHUNK = 8           # most components a staging buffer holds


class SceneGeometry(NamedTuple):
    """How the scene-assembly kernel covers a batch of (C, H, W) scenes
    (csrc/scene.cu): block (b, band, tile) takes blend b, rows
    ``[band * TY, band * TY + TY)`` and columns ``[tile * TX * XV,
    (tile + 1) * TX * XV)``; pixel thread ``p < TX * TY`` takes row ``p //
    TX`` of the band and the ``XV`` columns from ``(tile * TX + p % TX) *
    XV``.

    Direct walk (``staged`` false; at most ``SCENE_BANDS`` bands): thread
    ``p`` sums all C bands, reading each component's values itself.

    Staged walk: the C bands in NG balanced groups (group i: bands ``[i *
    C // NG, (i + 1) * C // NG)``, CG or CG - 1 of them), the block's
    threads in GT sets of P: thread ``g * P + p`` takes pixel thread p for
    groups g, g + GT, ... (``walks`` of the list; one where NG <= GT).
    The listed components' values at the block's pixels pass through two
    shared buffers of S components, each copied once, by the set ``j %
    GT`` for the j-th of a chunk."""
    XV: int           # consecutive columns a thread owns: 4, 2 or 1
    TX: int           # threads along a row
    TY: int           # rows of a block
    bands: int        # row bands of a scene
    tiles: int        # column tiles of a scene
    blocks: int
    threads: int      # a whole number of warps
    smem: int         # bytes: origins, list and seds (direct), or the
    #                   staging buffers, origins, list and flags (staged)
    staged: bool = True
    P: int = 0        # pixel threads of a set (whole warps)
    NG: int = 1       # band groups (the direct walk: one)
    CG: int = 0       # bands of the largest group (the kernel's)
    GT: int = 1       # staged: sets of P threads (groups walked at once)
    S: int = 0        # staged: components a staging buffer holds

    @property
    def route(self):
        return "staged" if self.staged else "direct"

    @property
    def walks(self):
        """Walks of the block's list a thread makes."""
        return -(-self.NG // self.GT)


def _scene_smem(K, C, S=0, P=0, XV=0, GT=0, CG=0):
    """Dynamic shared bytes of a scene-assembly block (csrc/scene.cu): the
    (K, 2) origins and the (K) list beside, on the direct walk (S = 0),
    the (K, C) seds, or on the staged walk two buffers of S components'
    values at P pixel threads of XV columns and of their seds (GT groups
    of CG, each rounded up to 4), and the (K) active bytes (in whole 16
    bytes)."""
    if not S:
        return 4 * K * (3 + C)
    return 4 * _quads(2 * S * (P * XV + GT * _quads(CG)) + 3 * K
                      + -(-K // 4))


def _scene_tile(W, H, XV, most):
    TX = min(W // XV, most)
    TY = max(1, min(H, most // TX))
    return TX, TY, -(-H // TY), -(-W // (TX * XV))


def _scene_pixel_threads(W, H, XV, cap):
    """P's bound for the staged walk: of SCENE_PIXEL_THREADS and twice it
    (those within ``cap``, else ``cap``), the one whose blocks keep more
    of their pixel threads at work (the warps' last threads and a row's
    last tile idle), the smaller on a tie: 64 at the fit's 58 x 48 and
    box 81's 80 x 80 (at 10 bands 0.0154 ms against 0.0163 at 128 on an
    H100, tools/gather_ab.py), 128 where a row is longer than 64
    threads."""
    def busy(most):
        TX, TY, _, tiles = _scene_tile(W, H, XV, most)
        P = max(32, -(-TX * TY // 32) * 32)
        return TX * TY / P * W / (tiles * TX * XV)
    return max([m for m in (SCENE_PIXEL_THREADS, 2 * SCENE_PIXEL_THREADS)
                if m <= cap] or [cap], key=busy)


@functools.lru_cache(maxsize=256)
def scene_geometry(B, K, C, H, W, route=None):
    """The launch geometry of the scene-assembly kernel.  ``route``
    ("staged" or "direct") overrides the shape's walk, for A/B timing
    (``tools.gather_ab``) and tests.

    The walk is the shape's: the direct walk up to ``SCENE_BANDS`` bands
    where its seds fit a block's shared memory, the staged walk past
    them.  Staged: NG = ceil(C / SCENE_BANDS) groups,
    GT = NG sets up to ``SCENE_THREADS // 32``, each of P threads, P up to
    ``SCENE_PIXEL_THREADS`` or twice it (``_scene_pixel_threads``) and
    ``SCENE_THREADS // GT``; buffers of S =
    min(K, SCENE_CHUNK) components, fewer where shared memory is short.
    Shared memory is the only limit: where one component's values and
    seds, twice, with the origins, list and active flags, do not fit a
    block, it raises ValueError naming the bytes."""
    XV = 4 if W % 4 == 0 else (2 if W % 2 == 0 else 1)
    staged = route == "staged" or (route is None and C > SCENE_BANDS)
    if not staged:
        if C > SCENE_BANDS:
            raise ValueError(f"scene_assembly: the direct walk takes at most "
                             f"{SCENE_BANDS} bands, not {C}")
        TX, TY, bands, tiles = _scene_tile(W, H, XV, SCENE_DIRECT_THREADS)
        smem = _scene_smem(K, C)
        threads = max(32, -(-TX * TY // 32) * 32)
        if smem <= SMEM_LIMIT:
            return SceneGeometry(XV, TX, TY, bands, tiles, B * bands * tiles,
                                 threads, smem, False, threads, 1, C)
        if route == "direct":
            raise ValueError(f"scene_assembly: the direct walk's {K} "
                             f"components of {C} bands need {smem} B of "
                             f"shared memory (at most {SMEM_LIMIT})")
    NG = -(-C // SCENE_BANDS)
    CG = -(-C // NG)
    GT = min(NG, SCENE_THREADS // 32)
    TX, TY, bands, tiles = _scene_tile(W, H, XV, _scene_pixel_threads(
        W, H, XV, SCENE_THREADS // GT // 32 * 32))
    P = max(32, -(-TX * TY // 32) * 32)
    S = max(1, min(K, SCENE_CHUNK))
    while S > 1 and _scene_smem(K, C, S, P, XV, GT, CG) > SMEM_LIMIT:
        S -= 1
    smem = _scene_smem(K, C, S, P, XV, GT, CG)
    if smem > SMEM_LIMIT:
        raise ValueError(f"scene_assembly: {K} components need {smem} B of "
                         f"shared memory (at most {SMEM_LIMIT})")
    return SceneGeometry(XV, TX, TY, bands, tiles, B * bands * tiles,
                         GT * P, smem, True, P, NG, CG, GT, S)


def scene_assembly(seds, morphs, origins, comp_active, scene_shape, pad):
    """Sum of the K factorized components of each blend, placed at their
    (possibly negative or overhanging) integer origins; boxes clip at the
    scene edge.

    seds (..., K, C) float32; morphs (..., K, hb, wb) float32 with unit
    column stride, read in place through its strides by the staged walk
    where its components lie a whole number of rows apart (else, and on
    the direct walk, copied first if not contiguous); origins (..., K, 2)
    integer scene coordinates of each box's corner; comp_active (..., K)
    bool.  Returns (..., C, H, W) for ``scene_shape = (C, H, W)``.
    ``pad`` is the overhang the plain version pads by (the kernel needs
    none).  Equal to the plain version bit for bit for finite inputs.
    """
    if _is_cpu(seds, morphs, origins, comp_active):
        return scene_assembly_plain(seds, morphs, origins, comp_active,
                                    scene_shape, pad)
    name = "scene_assembly"
    _require_cuda(name, seds, morphs, origins, comp_active)
    C, H, W = scene_shape
    K = seds.shape[-2]
    hb, wb = morphs.shape[-2:]
    lead = tuple(seds.shape[:-2])
    if (seds.shape[-1] != C or tuple(morphs.shape[:-2]) != lead + (K,)
            or tuple(origins.shape) != lead + (K, 2)
            or tuple(comp_active.shape) != lead + (K,)):
        raise ValueError(f"{name}: shapes do not match: seds "
                         f"{tuple(seds.shape)}, morphs {tuple(morphs.shape)},"
                         f" origins {tuple(origins.shape)}, comp_active "
                         f"{tuple(comp_active.shape)}")
    _f32(name, seds, "seds")
    if morphs.dtype != torch.float32:
        raise TypeError(f"{name}: morphs must be float32, got "
                        f"{morphs.dtype}")
    if morphs.stride(-1) != 1 and wb > 1:
        raise ValueError(f"{name}: morphs' column stride is "
                         f"{morphs.stride(-1)}; the kernel reads unit stride")
    try:
        m4 = morphs.view(-1, K, hb, wb)
    except RuntimeError:
        raise ValueError(f"{name}: morphs' leading dimensions do not merge "
                         f"into one stride {tuple(morphs.stride())}") from None
    org = origins.to(torch.int32).contiguous()
    act = comp_active.to(torch.bool).contiguous()
    out = torch.empty(lead + (C, H, W), dtype=seds.dtype, device=seds.device)
    B = seds.numel() // (K * C) if K * C else 0
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    g = scene_geometry(B, K, C, H, W)
    msb, msk, msy = m4.stride()[:3]
    if (not g.staged and not m4.is_contiguous()) or msy < wb or msk % msy:
        # the staged walk steps by rows (components a whole number of
        # rows apart); the direct walk reads contiguous morphologies
        m4 = m4.contiguous()
        msb, msk, msy = m4.stride()[:3]
    if (K - 1) * msk + (hb - 1) * msy + wb >= 2 ** 31:
        raise ValueError(f"{name}: a blend's morphologies span more than "
                         f"2**31 floats (strides {tuple(morphs.stride())})")
    lib = build.load()
    with torch.cuda.device(seds.device):
        err = lib.scarlet_scene_assembly(
            seds.data_ptr(), m4.data_ptr(), org.data_ptr(), act.data_ptr(),
            out.data_ptr(), B, K, C, hb, wb, msb, msk // msy, msy, H, W,
            int(g.staged), g.XV, g.TX, g.TY, g.P, g.NG, g.CG, g.S, g.bands,
            g.tiles, g.threads, g.smem, _stream(seds))
    _check(name, err)
    scene_assembly.launches += 1
    return out


scene_assembly.launches = 0


# ---------------------------------------------------------------------------
# K4: gradient gather
# ---------------------------------------------------------------------------
def grad_gather_plain(grad, seds, morphs, origins, pad):
    """Plain version of :func:`grad_gather` (engine.py:786-794 of the JAX
    package): per component, the window ``g`` of the gradient padded by
    ``pad``, ``g_sed = sum_hw g * morph`` and ``g_morph = sum_c sed_c *
    g_c`` (summed in c order).  Window pixels outside the array read 0, as
    in the kernel, so the unpadded gradient with ``pad = 0`` gives the
    same bits as the gradient zero-padded by P with ``pad = P``."""
    C, Hp, Wp = grad.shape[-3:]
    K = seds.shape[-2]
    hb, wb = morphs.shape[-2:]
    lead = seds.shape[:-2]
    grad = grad.reshape(-1, C, Hp, Wp).permute(0, 2, 3, 1)
    seds = seds.reshape(-1, K, C)
    morphs = morphs.reshape(-1, K, hb, wb)
    origins = origins.reshape(-1, K, 2)
    bi = torch.arange(grad.shape[0], device=grad.device)[:, None, None]
    g_seds, g_morphs = [], []
    for k in range(K):
        rows, cols = _windows(origins[:, k], pad, hb, wb)
        inside = (rows >= 0) & (rows < Hp) & (cols >= 0) & (cols < Wp)
        g = grad[bi, rows.clamp(0, Hp - 1), cols.clamp(0, Wp - 1)]
        g = torch.where(inside[..., None], g, 0.0).permute(0, 3, 1, 2)
        g_seds.append((g * morphs[:, k, None]).sum(dim=(-2, -1)))
        sed = seds[:, k, :, None, None]
        gm = sed[:, 0] * g[:, 0]
        for c in range(1, C):
            gm = gm + sed[:, c] * g[:, c]
        g_morphs.append(gm)
    g_seds = torch.stack(g_seds, 1).reshape(*lead, K, C)
    g_morphs = torch.stack(g_morphs, 1).reshape(*lead, K, hb, wb)
    return g_seds, g_morphs


GRAD_THREADS = 256        # threads of a gradient-gather block
GRAD_BLOCKS_PER_SM = 4    # the staged route's register budget: 64 a thread
GRAD_STAGED_BANDS = 8     # the staged route's largest band count
GRAD_TILE_BANDS = 64      # the tiled route's largest band group
GRAD_TILE_ROWS = 16       # the tiled route's largest row tile
SM_COUNT = 132            # SMs of an H100 SXM
SM_SMEM = 233472          # shared bytes of an SM (228 KB)
BLOCK_SMEM_RESERVED = 1024  # shared bytes the card keeps for each block


class GradGeometry(NamedTuple):
    """How the gradient-gather kernel covers a batch (csrc/grad.cu):
    block (b, group) takes blend b and components ``group * G`` to
    ``group * G + G - 1`` (those below K).

    Staged route (``staged``): the blend's whole gradient in shared
    memory; row ``y`` of component ``k`` falls to warp ``(k * hb + y) %
    (threads // 32)`` (whatever G is), whose lane ``l`` takes columns ``l,
    l + 32, ...`` of it, all C bands.

    Tiled route: the gradient rows that the group's windows cover, in
    tiles of ``tile_rows`` rows and ``band_group`` bands, streamed through
    two shared buffers with the morphology rows of each tile; warp ``w``
    walks component ``group * G + w // R`` and its window rows ``y`` with
    ``y % R == w % R`` (G = warps / R; R and G follow K and the box
    width alone), lane ``l`` columns ``l, l + 32, ...``, each window once
    per band group."""
    staged: bool      # the blend's gradient staged whole in shared memory
    G: int            # components per block
    groups: int       # blocks per blend
    blocks: int
    threads: int
    smem: int         # bytes: g_sed sums, origins, morphology and gradient
    blocks_per_sm: int  # what the shared memory and registers allow
    R: int = 0          # tiled: warps per component
    tile_rows: int = 0  # tiled: gradient rows per tile
    band_group: int = 0  # tiled: bands per walk of a window

    @property
    def route(self):
        return "staged" if self.staged else "tiled"


def _quads(n):
    return -(-n // 4) * 4


def _grad_smem(G, C, H, W, hb, wb):
    """Dynamic shared bytes of a staged gradient-gather block
    (csrc/grad.cu ``grad_kernel_staged``), in parts of whole 16 bytes: the
    (G, C, warps) g_sed sums, the group's seds and origins, two morphology
    buffers (each up to 3 floats in, at its alignment within 16 bytes)
    and the gradient plane (likewise shifted)."""
    mstride = (hb * wb + 6) // 4 * 4
    return 4 * (_quads(G * C * (GRAD_THREADS // 32)) + _quads(G * C)
                + _quads(2 * G) + 2 * mstride + C * H * W + 3)


def _tile_smem(G, NB, TR, W, wb):
    """Dynamic shared bytes of a tiled gradient-gather block (csrc/grad.cu
    ``grad_kernel_tiled``), in parts of whole 16 bytes: the two buffers'
    mbarriers, the (warps, NB) g_sed sums, the group's origins, two
    gradient tiles of NB bands x TR rows, each row a slot of ``W + 3``
    floats rounded up to 16 bytes (the row at its alignment offset), and
    two sets of G morphology spans of TR rows (likewise shifted)."""
    return 4 * (4 + _quads(GRAD_THREADS // 32 * NB) + _quads(2 * G)
                + 2 * NB * TR * _quads(W + 3) + 2 * G * _quads(TR * wb + 3))


def _tile_bands(C, nb):
    """The tiled route's instantiation for C bands in groups of nb: its
    registers hold kC seds and kC partials a thread, kC exact up to 16
    bands, then in steps of 8 (csrc/grad.cu ``tile_bands``); where a
    group does not fill it (kC > nb, or nb does not divide C) the guarded
    instantiation of at least 16 bands runs (``dispatch``)."""
    kC = nb if nb <= 16 else -(-nb // 8) * 8
    return kC if kC == nb and C % nb == 0 else max(kC, 16)


def _tile_blocks_per_sm(kC):
    """The blocks an SM holds of the tiled instantiation kC, as its
    ``__launch_bounds__`` sets the register budget (``tile_min_blocks``)."""
    return 3 if kC <= 12 else 2 if kC <= 40 else 1


def _warps_per_component(K, wb):
    """R of the tiled route: the block's 8 warps over G = 8 / R
    components, more warps per window where a blend has few, and four at
    least where a row is longer than a lane's two pixels (64): at box 81
    (32 blends of 16 components, 5 bands) R = 1, 2, 4 and 8 took 0.0409,
    0.0252, 0.0220 and 0.0324 ms on an H100 (tools/gather_ab.py)."""
    R = 8 if K <= 1 else 4 if K == 2 else 2 if K <= 4 else 1
    return max(R, 4) if wb > 64 else R


@functools.lru_cache(maxsize=256)
def grad_geometry(B, K, C, H, W, hb, wb, route=None, R=None):
    """The launch geometry of the gradient-gather kernel for B blends of
    K (hb, wb) components on (C, H, W) gradients (padding included).
    ``route`` ("staged" or "tiled") and ``R`` (1, 2, 4 or 8) override the
    shape's choice, for A/B timing (``tools.gather_ab``); a staged route
    that does not fit raises ValueError.

    The route is the shape's: the staged route where C is at most
    ``GRAD_STAGED_BANDS`` and two blocks, each with the gradient, two
    morphologies and one component's sums, fit an SM's shared memory
    (a block alone on an SM waits out its whole staging copy), else the
    tiled route.

    Staged: G is the fewest components per block that fills every SM with
    the most blocks it holds (up to ``GRAD_BLOCKS_PER_SM``) in one wave.
    Tiled: R and G follow K and the box alone (so a blend's sums do not
    depend on the batch); the band group is every band up to
    ``GRAD_TILE_BANDS``; the tile is the most rows (up to
    ``GRAD_TILE_ROWS``) with which the blocks
    an SM needs for one wave (at most what the registers allow) fit its
    shared memory, at least ``max(4, R)`` rows where the scene has them,
    fewer blocks an SM if not.  Only where one row of one band of the
    gradient does not fit a block twice beside the morphology rows does
    it raise ValueError naming the bytes."""
    fits = C <= GRAD_STAGED_BANDS and 2 * (
        _grad_smem(1, C, H, W, hb, wb) + BLOCK_SMEM_RESERVED) <= SM_SMEM
    if route == "staged" and not fits:
        raise ValueError(f"grad_gather: the staged route does not take "
                         f"{(C, H, W)} gradients")
    if fits and route != "tiled":
        cap = max(1, K)
        for bps in range(GRAD_BLOCKS_PER_SM, 0, -1):
            G = min(cap, max(1, -(-B * K // (SM_COUNT * bps))))
            while G > 1 and _grad_smem(G, C, H, W, hb, wb) > SMEM_LIMIT:
                G -= 1
            smem = _grad_smem(G, C, H, W, hb, wb)
            if bps == 1 or bps * (smem + BLOCK_SMEM_RESERVED) <= SM_SMEM:
                break
        groups = -(-K // G) if K else 0
        return GradGeometry(True, G, groups, B * groups, GRAD_THREADS, smem,
                            bps)
    R = R or _warps_per_component(K, wb)
    G = GRAD_THREADS // 32 // R
    groups = -(-K // G) if K else 0
    rows = max(1, min(GRAD_TILE_ROWS, H))
    for NB in range(min(C, GRAD_TILE_BANDS), 0, -1):
        reg = _tile_blocks_per_sm(_tile_bands(C, NB))
        want = min(reg, max(1, -(-B * groups // SM_COUNT)))
        for bps in range(want, 0, -1):
            budget = min(SMEM_LIMIT, SM_SMEM // bps - BLOCK_SMEM_RESERVED)
            TR = max((t for t in range(1, rows + 1)
                      if _tile_smem(G, NB, t, W, wb) <= budget), default=0)
            if TR >= min(rows, max(4, R)) or (bps == 1 and TR):
                return GradGeometry(False, G, groups, B * groups,
                                    GRAD_THREADS, _tile_smem(G, NB, TR, W, wb),
                                    bps, R, TR, NB)
    smem = _tile_smem(G, 1, 1, W, wb)
    raise ValueError(f"grad_gather: one row of one band of a {W} px wide "
                     f"gradient, with {G} ({hb}, {wb}) components, needs "
                     f"{smem} B of shared memory (at most {SMEM_LIMIT})")


def grad_gather(grad, seds, morphs, origins, pad):
    """Per-component (g_sed, g_morph) from the scene gradient ``grad``,
    padded by ``pad`` on both spatial sides (the fit passes the unpadded
    gradient and 0).

    grad (..., C, H+2P, W+2P) float32 with unit column stride, read in
    place through its strides (no copy); seds (..., K, C), morphs (..., K,
    hb, wb) float32; origins (..., K, 2) integer.  Returns ((..., K, C),
    (..., K, hb, wb)).  g_morph equals the plain version bit for bit;
    g_sed to float32 roundoff of its hb*wb-term sum (reduction order), the
    same bits from run to run and in any batch.  The route
    (:func:`grad_geometry`) follows the shapes.
    """
    if _is_cpu(grad, seds, morphs, origins):
        return grad_gather_plain(grad, seds, morphs, origins, pad)
    name = "grad_gather"
    _require_cuda(name, grad, seds, morphs, origins)
    C, Hp, Wp = grad.shape[-3:]
    K = seds.shape[-2]
    hb, wb = morphs.shape[-2:]
    lead = tuple(seds.shape[:-2])
    if (seds.shape[-1] != C or tuple(grad.shape[:-3]) != lead
            or tuple(morphs.shape[:-2]) != lead + (K,)
            or tuple(origins.shape) != lead + (K, 2)):
        raise ValueError(f"{name}: shapes do not match: grad "
                         f"{tuple(grad.shape)}, seds {tuple(seds.shape)}, "
                         f"morphs {tuple(morphs.shape)}, origins "
                         f"{tuple(origins.shape)}")
    if grad.dtype != torch.float32:
        raise TypeError(f"{name}: grad must be float32, got {grad.dtype}")
    if grad.stride(-1) != 1 and Wp > 1:
        raise ValueError(f"{name}: grad's column stride is "
                         f"{grad.stride(-1)}; the kernel reads unit stride")
    try:
        g4 = grad.view(-1, C, Hp, Wp)
    except RuntimeError:
        raise ValueError(f"{name}: grad's leading dimensions do not merge "
                         f"into one stride {tuple(grad.stride())}") from None
    _f32(name, seds, "seds")
    _f32(name, morphs, "morphs")
    org = origins.to(torch.int32).contiguous()
    g_seds = torch.empty_like(seds)
    g_morphs = torch.empty_like(morphs)
    B = seds.numel() // (K * C) if K * C else 0
    if B * K == 0:
        return g_seds, g_morphs
    geo = grad_geometry(B, K, C, Hp, Wp, hb, wb)
    lib = build.load()
    with torch.cuda.device(grad.device):
        err = lib.scarlet_grad_gather(
            g4.data_ptr(), seds.data_ptr(), morphs.data_ptr(),
            org.data_ptr(), g_seds.data_ptr(), g_morphs.data_ptr(), B, K, C,
            hb, wb, Hp, Wp, int(pad), *g4.stride()[:3], int(geo.staged),
            geo.G, geo.groups, geo.smem, geo.R, geo.tile_rows,
            geo.band_group, _stream(grad))
    _check(name, err)
    grad_gather.launches += 1
    return g_seds, g_morphs


grad_gather.launches = 0


def gather_kernel_info(B, K, C, H, W, hb, wb):
    """What the compiler made of the scene-assembly and gradient-gather
    kernels at these shapes (card only; (H, W) is the gradient's, so a
    padded shape shows its route): per kernel, registers per thread,
    local-memory (spill) bytes per thread, threads, dynamic shared bytes,
    blocks resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the grid."""
    import ctypes

    lib = build.load()
    sg = scene_geometry(B, K, C, H, W)
    gg = grad_geometry(B, K, C, H, W, hb, wb)
    out = {}
    for name, err, geo, extra in (
            ("scene_assembly", lambda v: lib.scarlet_scene_kernel_info(
                int(sg.staged), sg.XV, sg.CG, sg.threads, sg.smem, v), sg,
             dict(grid=(B, sg.bands, sg.tiles), XV=sg.XV, TX=sg.TX,
                  TY=sg.TY, route=sg.route, P=sg.P, NG=sg.NG, CG=sg.CG,
                  GT=sg.GT, S=sg.S, walks=sg.walks)),
            ("grad_gather", lambda v: lib.scarlet_grad_kernel_info(
                int(gg.staged), C, gg.band_group, gg.smem, v), gg,
             dict(grid=(B, gg.groups), G=gg.G, route=gg.route, R=gg.R,
                  tile_rows=gg.tile_rows, band_group=gg.band_group))):
        vals = (ctypes.c_int * 3)()
        _check(name, err(vals))
        out[name] = dict(registers=vals[0], spill_bytes=vals[1],
                         blocks_per_sm=vals[2], threads=geo.threads,
                         smem_bytes=geo.smem, blocks=geo.blocks, **extra)
    return out


_COUNTED = (monotonic_prox, prox_chain, fused_morph_update, scene_assembly,
            grad_gather, mono_pass_variant)


def launch_counts():
    """Kernel launches since the last :func:`reset_launch_counts`
    (``monotonic_prox`` counts both of its layouts and both engines;
    ``monotonic_prox_tol_tensor`` those of its launches that read one
    tolerance per blend; ``monotonic_prox_wide`` those that ran the wide
    engine's ``mono_kernel_wide``, for boxes beyond :func:`mono_geometry`.
    ``prox_chain`` and ``fused_morph_update`` count their register
    kernels, ``prox_chain_wide`` and ``fused_morph_update_wide`` their
    wide kernels, ``chain_kernel_wide`` and ``fused_kernel_wide``: a wide
    K5 or K6 call is one launch of its own kernel and adds nothing to
    ``monotonic_prox`` or ``monotonic_prox_wide``)."""
    out = {f.__name__: f.launches for f in _COUNTED}
    out["monotonic_prox_tol_tensor"] = monotonic_prox.tol_tensor_launches
    out["monotonic_prox_wide"] = monotonic_prox.wide_launches
    out["prox_chain_wide"] = prox_chain.wide_launches
    out["fused_morph_update_wide"] = fused_morph_update.wide_launches
    return out


def reset_launch_counts():
    for f in _COUNTED:
        f.launches = 0
    for f in (monotonic_prox, prox_chain, fused_morph_update):
        f.wide_launches = 0
    monotonic_prox.tol_tensor_launches = 0
