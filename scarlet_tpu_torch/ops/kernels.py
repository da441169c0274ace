"""The three Hopper kernels of the lite fit loop and their plain PyTorch
versions.

=====================  ==========================  =======================
wrapper                CUDA source                 TPU kernel it replaces
=====================  ==========================  =======================
monotonic_prox         csrc/mono.cu                ``batched_monotonic_prox``
monotonic_prox_packed  csrc/mono.cu (strided)      ``monotonic_prox_packed``
scene_assembly         csrc/scene.cu               ``scene_assembly``
grad_gather            csrc/grad.cu                ``grad_gather``
=====================  ==========================  =======================

(TPU kernels: ``scarlet_tpu/ops/pallas_kernels.py``.)

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
strides.
"""
from __future__ import annotations

import torch

from . import build
from .prox import NEIGHBOR_OFFSETS, shift_zero

__all__ = [
    "MONO_UNROLL",
    "monotonic_prox",
    "monotonic_prox_packed",
    "scene_assembly",
    "grad_gather",
    "monotonic_prox_plain",
    "monotonic_prox_packed_plain",
    "scene_assembly_plain",
    "grad_gather_plain",
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
    ref = torch.zeros_like(x)
    for d, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        ref = ref + w[..., d, :, :] * shift_zero(x, dy, dx)
    return torch.where(keep, x0, torch.minimum(x0, ref * scale))


def monotonic_prox_plain(morphs, idx, weights_table, keep_table, n_iter,
                         min_gradient=0.0, tol=0.0):
    """Plain version of :func:`monotonic_prox` (engine.py:635-647 of the
    JAX package, with the kernel's exit rule): Jacobi passes in blocks of
    ``MONO_UNROLL``; a morphology stops after the block whose last pass
    changed nothing (``tol == 0``) or moved no pixel by more than ``tol``,
    or once ``n_iter`` passes have run.  At ``tol == 0`` this is the exact
    fixed point, equal to ``n_iter`` plain passes."""
    idx = idx.long()
    w = weights_table[idx]                   # (..., K, 8, hb, wb)
    keep = keep_table[idx] > 0.5             # (..., K, hb, wb)
    scale = 1.0 - min_gradient
    x0 = morphs
    x = x0
    running = torch.ones(morphs.shape[:-2], dtype=torch.bool,
                         device=morphs.device)
    t = 0
    while t < n_iter and bool(running.any()):
        start = x
        for _ in range(MONO_UNROLL - 1):
            x = _mono_pass(x, x0, w, keep, scale)
        new = _mono_pass(x, x0, w, keep, scale)
        if tol > 0.0:
            changed = (new - x).abs().amax(dim=(-2, -1)) > tol
        else:
            changed = (new != x).any(dim=-1).any(dim=-1)
        x = torch.where(running[..., None, None], new, start)
        running = running & changed
        t += MONO_UNROLL
    return x


def monotonic_prox(morphs, idx, weights_table, keep_table, n_iter,
                   min_gradient=0.0, tol=0.0):
    """Radially monotonic projection of a stack of morphologies.

    morphs: (..., K, hb, wb) float32; idx: (..., K) integer table index
    (candidate center) per morphology; weights_table: (ncand, 8, hb, wb);
    keep_table: (ncand, hb, wb), 1.0 at the never-updated center;
    n_iter: the DAG depth (``monotonic_depth``); tol: static exit
    tolerance (0 = exact).

    Exits per morphology (the TPU kernel exits per group of lane-packed
    morphologies; the two agree exactly at ``tol == 0`` and with a group
    of one at ``tol > 0``).
    """
    if _is_cpu(morphs, idx, weights_table, keep_table):
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
    if _is_cpu(packed, idx, weights_table, keep_table):
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


def _mono_launch(name, x, idx, weights_table, keep_table, K, hb, wb, strides,
                 n_iter, min_gradient, tol):
    _require_cuda(name, x, idx, weights_table, keep_table)
    _f32(name, weights_table, "weights_table")
    _f32(name, keep_table, "keep_table")
    ncand = weights_table.shape[0]
    if (tuple(weights_table.shape) != (ncand, 8, hb, wb)
            or tuple(keep_table.shape) != (ncand, hb, wb)):
        raise ValueError(f"{name}: tables {tuple(weights_table.shape)}, "
                         f"{tuple(keep_table.shape)} do not fit box "
                         f"({hb}, {wb})")
    lib = build.load()
    smem = lib.scarlet_mono_smem_bytes(hb, wb)
    if smem > 232448:
        raise ValueError(f"{name}: box ({hb}, {wb}) needs {smem} B of "
                         "shared memory, more than 227 KB")
    idx32 = idx.to(torch.int32).contiguous()
    B = x.numel() // (K * hb * wb)
    out = torch.empty_like(x)
    if B * K == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.scarlet_mono_prox(
            x.data_ptr(), out.data_ptr(), idx32.data_ptr(),
            weights_table.data_ptr(), keep_table.data_ptr(), ncand, B, K,
            hb, wb,
            *strides, int(n_iter), 1.0 - float(min_gradient), float(tol),
            _stream(x))
    _check(name, err)
    monotonic_prox.launches += 1
    return out


monotonic_prox.launches = 0


# ---------------------------------------------------------------------------
# K3: scene assembly
# ---------------------------------------------------------------------------
def _check_pad(origins, box, hw, pad):
    """The plain versions index a scene padded by ``pad``: every box must
    fit inside it (a negative slice start would wrap around silently)."""
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
    zero scene padded by ``pad``, in component order, then crop."""
    C, H, W = scene_shape
    K = seds.shape[-2]
    hb, wb = morphs.shape[-2:]
    lead = seds.shape[:-2]
    seds = seds.reshape(-1, K, C)
    morphs = morphs.reshape(-1, K, hb, wb)
    origins = origins.reshape(-1, K, 2)
    on = comp_active.reshape(-1, K).to(seds.dtype)
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


def scene_assembly(seds, morphs, origins, comp_active, scene_shape, pad):
    """Sum of the K factorized components of each blend, placed at their
    (possibly negative or overhanging) integer origins; boxes clip at the
    scene edge.

    seds (..., K, C), morphs (..., K, hb, wb) float32; origins (..., K, 2)
    integer scene coordinates of each box's corner; comp_active (..., K)
    bool.  Returns (..., C, H, W) for ``scene_shape = (C, H, W)``.
    ``pad`` is the overhang the plain version pads by (the kernel needs
    none).
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
    _f32(name, morphs, "morphs")
    org = origins.to(torch.int32).contiguous()
    act = comp_active.to(torch.bool).contiguous()
    out = torch.empty(lead + (C, H, W), dtype=seds.dtype, device=seds.device)
    B = seds.numel() // (K * C) if K * C else 0
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.load()
    with torch.cuda.device(seds.device):
        err = lib.scarlet_scene_assembly(
            seds.data_ptr(), morphs.data_ptr(), org.data_ptr(),
            act.data_ptr(), out.data_ptr(), B, K, C, hb, wb, H, W,
            _stream(seds))
    _check(name, err)
    scene_assembly.launches += 1
    return out


scene_assembly.launches = 0


# ---------------------------------------------------------------------------
# K4: gradient gather
# ---------------------------------------------------------------------------
def grad_gather_plain(gpad, seds, morphs, origins, pad):
    """Plain version of :func:`grad_gather` (engine.py:786-794 of the JAX
    package): per component, the window ``g`` of the padded gradient,
    ``g_sed = sum_hw g * morph`` and ``g_morph = sum_c sed_c * g_c``
    (summed in c order)."""
    C, Hp, Wp = gpad.shape[-3:]
    K = seds.shape[-2]
    hb, wb = morphs.shape[-2:]
    lead = seds.shape[:-2]
    gpad = gpad.reshape(-1, C, Hp, Wp).permute(0, 2, 3, 1)
    seds = seds.reshape(-1, K, C)
    morphs = morphs.reshape(-1, K, hb, wb)
    origins = origins.reshape(-1, K, 2)
    _check_pad(origins, (hb, wb), (Hp - 2 * pad, Wp - 2 * pad), pad)
    bi = torch.arange(gpad.shape[0], device=gpad.device)[:, None, None]
    g_seds, g_morphs = [], []
    for k in range(K):
        rows, cols = _windows(origins[:, k], pad, hb, wb)
        g = gpad[bi, rows, cols].permute(0, 3, 1, 2)      # (B, C, hb, wb)
        g_seds.append((g * morphs[:, k, None]).sum(dim=(-2, -1)))
        sed = seds[:, k, :, None, None]
        gm = sed[:, 0] * g[:, 0]
        for c in range(1, C):
            gm = gm + sed[:, c] * g[:, c]
        g_morphs.append(gm)
    g_seds = torch.stack(g_seds, 1).reshape(*lead, K, C)
    g_morphs = torch.stack(g_morphs, 1).reshape(*lead, K, hb, wb)
    return g_seds, g_morphs


def grad_gather(gpad, seds, morphs, origins, pad):
    """Per-component (g_sed, g_morph) from the scene gradient ``gpad``,
    padded by ``pad`` on both spatial sides.

    gpad (..., C, H+2P, W+2P), seds (..., K, C), morphs (..., K, hb, wb)
    float32; origins (..., K, 2) integer.  Returns ((..., K, C),
    (..., K, hb, wb)).  g_morph equals the plain version bit for bit;
    g_sed to float32 roundoff of its hb*wb-term sum (reduction order).
    """
    if _is_cpu(gpad, seds, morphs, origins):
        return grad_gather_plain(gpad, seds, morphs, origins, pad)
    name = "grad_gather"
    _require_cuda(name, gpad, seds, morphs, origins)
    C, Hp, Wp = gpad.shape[-3:]
    K = seds.shape[-2]
    hb, wb = morphs.shape[-2:]
    lead = tuple(seds.shape[:-2])
    if (seds.shape[-1] != C or tuple(gpad.shape[:-3]) != lead
            or tuple(morphs.shape[:-2]) != lead + (K,)
            or tuple(origins.shape) != lead + (K, 2)):
        raise ValueError(f"{name}: shapes do not match: gpad "
                         f"{tuple(gpad.shape)}, seds {tuple(seds.shape)}, "
                         f"morphs {tuple(morphs.shape)}, origins "
                         f"{tuple(origins.shape)}")
    for t, what in ((gpad, "gpad"), (seds, "seds"), (morphs, "morphs")):
        _f32(name, t, what)
    lib = build.load()
    if C > lib.scarlet_grad_max_bands():
        raise ValueError(f"{name}: {C} bands; the kernel takes at most "
                         f"{lib.scarlet_grad_max_bands()}")
    org = origins.to(torch.int32).contiguous()
    g_seds = torch.empty_like(seds)
    g_morphs = torch.empty_like(morphs)
    B = seds.numel() // (K * C) if K * C else 0
    if B * K == 0:
        return g_seds, g_morphs
    with torch.cuda.device(gpad.device):
        err = lib.scarlet_grad_gather(
            gpad.data_ptr(), seds.data_ptr(), morphs.data_ptr(),
            org.data_ptr(), g_seds.data_ptr(), g_morphs.data_ptr(), B, K, C,
            hb, wb, Hp, Wp, int(pad), _stream(gpad))
    _check(name, err)
    grad_gather.launches += 1
    return g_seds, g_morphs


grad_gather.launches = 0


_COUNTED = (monotonic_prox, scene_assembly, grad_gather)


def launch_counts():
    """Kernel launches since the last :func:`reset_launch_counts`
    (``monotonic_prox`` counts both of its layouts)."""
    return {f.__name__: f.launches for f in _COUNTED}


def reset_launch_counts():
    for f in _COUNTED:
        f.launches = 0
