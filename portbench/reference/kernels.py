"""Frozen copy of the plain versions of the port's kernels
(``ops/kernels.py``): K1's projection with its exit rule, the candidate
index and prox epilogue, K3's scene assembly and K4's gradient gather,
verbatim.  The names the engine calls are bound to the plain versions
at the end: nothing here launches a hand-written kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .prox import NEIGHBOR_OFFSETS


MONO_UNROLL = 4


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


# what the engine and the init call, as the port's dispatchers call them
# on tensors of the CPU
monotonic_prox = monotonic_prox_plain
scene_assembly = scene_assembly_plain
grad_gather = grad_gather_plain
