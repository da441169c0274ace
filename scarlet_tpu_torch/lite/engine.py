"""The lite fit engine: the proximal-Adam fit loop of one blend or of a
batch of blends, on torch tensors.

Port of ``scarlet_tpu/lite/engine.py``.  Per iteration (``fit_step``):

1. assemble the scene from the components (kernel ``scene_assembly``);
2. convolve with the PSF difference kernel (``torch.fft``);
3. weighted residual and logL;
4. convolve the residual with the flipped kernel;
5. gather per-component SED and morphology gradients (kernel
   ``grad_gather``) -- the gradients are analytic, no autograd;
6. adaprox steps;
7. the morphology prox chain: box mask, candidate-center pick,
   monotonicity (kernel ``monotonic_prox``), background threshold, center
   floor, max-normalization (kernel ``prox_chain`` for the whole chain,
   or ``fused_morph_update`` for step and chain, where the config asks);
8. the per-blend convergence mask.

A batch is a leading axis on every per-blend tensor of ``BlendData`` and
``BlendState`` (the monotonicity tables are shared and unbatched); one
blend has no leading axis.  Every function here takes either.  The
kernels run where the tensors are: on the card for CUDA tensors, as their
plain PyTorch versions on the CPU.

Components live in per-size buckets, each (…, K, hb, wb).  The JAX
package's lane-packed layout (``packed_morphs``) is a TPU device; here
the layout stays, but the config takes the same branch of the morphology
update as the JAX ``fit_step`` (:func:`_morph_update`): the packed
branch's per-slot threshold cutoff, its one-pass prox chain
(``packed_prox_chain``, kernel ``prox_chain``) and the fused update
(``fuse_morph``, kernel ``fused_morph_update``).  Options the port does
not run yet raise ``NotImplementedError`` (see :func:`check_supported`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import default_device
from ..ops import fft as fft_ops
from ..ops import kernels
from ..ops import prox as prox_ops
from ..optim import AdaproxState, init_adaprox_state, adaprox_step

__all__ = [
    "LiteFitConfig",
    "BlendData",
    "BlendState",
    "AdaproxState",
    "init_adaprox_state",
    "map_tree",
    "pin_float32",
    "check_supported",
    "packed_morphs_ok",
    "make_scene",
    "render",
    "fit_step",
    "fit_scan",
    "make_blend_data",
    "make_blend_state",
    "monotonicity_tables",
    "shared_tensors",
]


@dataclass(frozen=True)
class LiteFitConfig:
    """Static fit configuration, field for field the JAX package's, so a
    config converts one to one (``dataclasses.asdict``).

    ``use_pallas``, ``use_pallas_scene``, ``packed_morphs``,
    ``packed_prox_chain`` and ``fuse_morph`` select the branch of the
    morphology update as in the JAX package (:func:`packed_morphs_ok`);
    the tensors' device picks kernel or plain version, and the layout is
    always (…, K, hb, wb).  ``pallas_interpret`` and ``conv_precision``
    are carried for the conversion and change nothing here.
    """
    scene_shape: tuple            # (C, H, W)
    box_shapes: tuple             # ((hb, wb), ...) per bucket
    bucket_counts: tuple          # (Kb, ...) per bucket
    fft_shape: Optional[tuple]    # spatial FFT shape; None = no convolution
    mono_n_iters: tuple = ()      # per bucket; from monotonicity_tables
    optimizer: str = "adaprox"    # only "adaprox" is ported
    scheme: str = "amsgrad"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    p: float = 0.25
    max_prox_iter: int = 1
    floor: float = 1e-20
    bg_thresh: Optional[float] = 0.25
    morph_step: float = 1e-2
    sed_step_factor: float = 1e-2
    e_rel: float = 1e-4
    min_iter: int = 1
    fit_center_radius: int = 1
    min_gradient: float = 0.0
    # static exit tolerance of the monotonicity kernel: 0 = the exact
    # fixed point; > 0 exits once a 4-pass block moves no pixel by more
    # than mono_tol (morphs are unit-peak)
    mono_tol: float = 0.0
    mono_tol_early: float = 0.0   # not ported: must stay off
    mono_tol_switch: int = 0      # not ported: must stay 0
    mono_every: int = 1           # not ported: must stay 1
    box_grow: Optional[float] = None  # not ported: must stay None
    box_grow_step: int = 5
    neighbor_weight: str = "angle"
    use_pallas: bool = False
    use_pallas_scene: bool = False
    fuse_morph: bool = False      # fused morphology update (K6)
    packed_morphs: bool = False   # the packed branch (packed_morphs_ok)
    packed_prox_chain: bool = False  # its one-pass prox chain (K5)
    conv_mode: str = "fft"        # only "fft" is ported
    conv_precision: str = "float32"
    pallas_interpret: bool = False
    scene_pad: int = -1           # -1: one full (largest) box
    band_axis: Optional[str] = None   # not ported: must stay None
    n_bands_total: Optional[int] = None

    @property
    def n_buckets(self):
        return len(self.box_shapes)

    @property
    def pad(self):
        """Scene padding that covers the largest out-of-scene box
        overhang."""
        if self.scene_pad >= 0:
            return self.scene_pad
        return max(max(s) for s in self.box_shapes)


class BlendData(NamedTuple):
    """Per-blend constants; bucketed fields are tuples, one per bucket."""
    images: torch.Tensor             # (…, C, H, W)
    weights: torch.Tensor            # (…, C, H, W)
    kernel_rfft: Optional[torch.Tensor]       # (…, C, fh, fw//2+1) complex
    grad_kernel_rfft: Optional[torch.Tensor]  # flipped kernel, same shape
    bg_rms: torch.Tensor             # (…, C) noise RMS per band
    sed_step_min: torch.Tensor       # (…, C) minimum SED step
    mono_weights: tuple              # per bucket: (ncand, 8, hb, wb), shared
    mono_keep: tuple                 # per bucket: (ncand, hb, wb), shared
    box_masks: Optional[tuple] = None   # per bucket: (…, Kb, hb, wb), 1
    # inside each component's logical box
    scene_mask: Optional[torch.Tensor] = None  # (…, H, W), 1 on real
    # scene pixels of a blend zero-padded to a shared layout


class BlendState(NamedTuple):
    """Per-blend fit state; bucketed fields are tuples."""
    seds: tuple                  # per bucket: (…, Kb, C)
    morphs: tuple                # per bucket: (…, Kb, hb, wb)
    origins: tuple               # per bucket: (…, Kb, 2) int32
    comp_active: tuple           # per bucket: (…, Kb) bool
    sed_opt: tuple               # per bucket: AdaproxState
    morph_opt: tuple             # per bucket: AdaproxState
    active: torch.Tensor         # (…) bool: blend still iterating
    it: torch.Tensor             # (…) int32: iterations executed
    last_loss: torch.Tensor      # (…) float: previous logL


def map_tree(fn, tree, *rest):
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``): nested tuples and NamedTuples such as BlendData,
    BlendState and AdaproxState; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [map_tree(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return fn(tree, *rest)


def check_supported(config):
    """Raise ``NotImplementedError`` for options the port does not run."""
    off = {
        "optimizer": (config.optimizer != "adaprox", "'adaprox'"),
        "box_grow": (config.box_grow is not None, "None"),
        "band_axis": (config.band_axis is not None, "None"),
        "mono_tol_switch": (config.mono_tol_switch > 0, "0"),
        "mono_every": (config.mono_every > 1, "1"),
        "conv_mode": (config.conv_mode != "fft", "'fft'"),
    }
    for name, (bad, want) in off.items():
        if bad:
            raise NotImplementedError(
                f"LiteFitConfig.{name}={getattr(config, name)!r} is not "
                f"ported yet (supported: {want})")


def packed_morphs_ok(config):
    """Whether the JAX package runs this config's fit on its packed
    branch (scarlet_tpu/lite/engine.py:346-354): the per-slot threshold
    cutoff, and the one-pass prox chain with ``packed_prox_chain``."""
    if not (config.packed_morphs and config.n_buckets == 1
            and config.use_pallas and config.use_pallas_scene
            and config.optimizer == "adaprox"
            and config.band_axis is None):
        return False
    hb, wb = config.box_shapes[0]
    return config.bucket_counts[0] * wb <= 4096


def _fused_ok(config):
    """Whether the JAX ``fit_step`` takes the fused morphology update
    (scarlet_tpu/lite/engine.py:939-943; box growth is not ported)."""
    return (config.use_pallas and config.fuse_morph
            and config.scheme == "amsgrad" and config.max_prox_iter <= 1
            and config.band_axis is None)


# ---------------------------------------------------------------------------
# Setup helpers (host-side)
# ---------------------------------------------------------------------------
def monotonicity_tables(box_shape, fit_center_radius=1,
                        neighbor_weight="angle"):
    """Stacked monotonicity weight tables for every candidate center in
    the (2r+1)^2 window around the box center (row-major, like
    ``argmax`` over the window).

    Returns numpy (weights (ncand, 8, hb, wb), keep (ncand, hb, wb),
    n_iter), memoized.
    """
    from ..cache import Cache

    key = (tuple(box_shape), int(fit_center_radius), neighbor_weight)
    try:
        return Cache.check("monotonicity_tables", key)
    except KeyError:
        pass
    Hb, Wb = box_shape
    bc = (Hb // 2, Wb // 2)
    r = int(fit_center_radius)
    centers = [
        (bc[0] + dy, bc[1] + dx)
        for dy in range(-r, r + 1)
        for dx in range(-r, r + 1)
    ] if r > 0 else [bc]

    weights, keeps, n_iter = [], [], 0
    for c in centers:
        w = prox_ops.monotonic_weights(box_shape, neighbor_weight, c)
        weights.append(w)
        keep = np.zeros(box_shape, np.float32)
        keep[c] = 1.0
        keeps.append(keep)
        n_iter = max(n_iter, prox_ops.monotonic_depth(w, box_shape, c))
    out = (np.stack(weights), np.stack(keeps), n_iter)
    Cache.set("monotonicity_tables", key, out)
    return out


def shared_tensors(name, key, arrays, device):
    """``arrays`` (host numpy) on ``device``, uploaded once per (name,
    key, device) and shared by every caller: for read-only tables such as
    the monotonicity tables, whose compact taps the projection kernel then
    builds once (``ops.kernels``), not once per blend or chunk."""
    from ..cache import Cache

    k = (key, str(torch.device(device)))
    try:
        return Cache.check(name, k)
    except KeyError:
        pass
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays)
    Cache.set(name, k, out)
    return out


def _tensor(x, device, dtype=None):
    """``x`` (array-like or tensor) as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def pin_float32(device):
    """Keep float32 contractions in full float32 on a CUDA ``device``:
    turn TF32 off for matmuls and cuDNN (cuDNN convolutions default to
    TF32).  Lower-precision contractions are known to change the
    reference's fitted solution, not only its last digits."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def make_blend_data(images, weights, diff_kernel, bg_rms, config,
                    sed_step_min=None, device=None):
    """Build one blend's BlendData on ``device`` (default: the device of
    ``images`` if it is a tensor, else the CUDA card).  Kernel transforms
    are computed on the host, so every device starts from the same
    bits."""
    device = default_device(device, images)
    pin_float32(device)
    images = _tensor(images, "cpu")
    dtype = images.dtype
    if diff_kernel is not None:
        diff_kernel = _tensor(diff_kernel, "cpu", dtype)
        kernel_rfft = fft_ops.transform(diff_kernel, config.fft_shape,
                                        (-2, -1)).to(device)
        grad_kernel_rfft = fft_ops.transform(
            torch.flip(diff_kernel, (-2, -1)), config.fft_shape,
            (-2, -1)).to(device)
    else:
        kernel_rfft = grad_kernel_rfft = None

    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    mono_w, mono_keep = [], []
    for shape in config.box_shapes:
        key = (tuple(shape), config.fit_center_radius,
               config.neighbor_weight)
        w, keep, _ = monotonicity_tables(*key)
        w, keep = shared_tensors(f"monotonicity_tables_{np_dtype}", key,
                                 (w.astype(np_dtype), keep.astype(np_dtype)),
                                 device)
        mono_w.append(w)
        mono_keep.append(keep)

    bg_rms = _tensor(bg_rms, "cpu", dtype)
    if sed_step_min is None:
        sed_step_min = bg_rms / 10.0
    return BlendData(
        images=images.to(device),
        weights=_tensor(weights, device, dtype),
        kernel_rfft=kernel_rfft,
        grad_kernel_rfft=grad_kernel_rfft,
        bg_rms=bg_rms.to(device),
        sed_step_min=_tensor(sed_step_min, device, dtype),
        mono_weights=tuple(mono_w),
        mono_keep=tuple(mono_keep),
    )


def make_blend_state(seds, morphs, origins, comp_active=None,
                     sed_opt=None, morph_opt=None, device=None):
    """One blend's BlendState from per-bucket lists of arrays (or single
    arrays for one bucket), on ``device`` (default: the device of the
    first SEDs if they are a tensor, else the CUDA card)."""
    def as_buckets(x):
        if isinstance(x, (list, tuple)) and not isinstance(x, AdaproxState):
            return tuple(x)
        return (x,)

    device = default_device(device, as_buckets(seds)[0])

    seds = tuple(_tensor(s, device) for s in as_buckets(seds))
    morphs = tuple(_tensor(m, device) for m in as_buckets(morphs))
    origins = tuple(_tensor(o, device, torch.int32)
                    for o in as_buckets(origins))
    if comp_active is None:
        comp_active = tuple(torch.ones(s.shape[0], dtype=torch.bool,
                                       device=device) for s in seds)
    else:
        comp_active = tuple(_tensor(a, device, torch.bool)
                            for a in as_buckets(comp_active))
    if sed_opt is None:
        sed_opt = tuple(init_adaprox_state(s) for s in seds)
    else:
        sed_opt = as_buckets(sed_opt)
    if morph_opt is None:
        morph_opt = tuple(init_adaprox_state(m) for m in morphs)
    else:
        morph_opt = as_buckets(morph_opt)
    dtype = seds[0].dtype
    return BlendState(
        seds=seds,
        morphs=morphs,
        origins=origins,
        comp_active=comp_active,
        sed_opt=sed_opt,
        morph_opt=morph_opt,
        active=torch.tensor(True, device=device),
        it=torch.tensor(0, dtype=torch.int32, device=device),
        last_loss=torch.tensor(float("inf"), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# Forward model
# ---------------------------------------------------------------------------
def make_scene(state, config):
    """Sum of all buckets' components, (…, C, H, W); boxes clip at the
    scene edge."""
    scene = None
    for b in range(config.n_buckets):
        part = kernels.scene_assembly(
            state.seds[b], state.morphs[b], state.origins[b],
            state.comp_active[b], config.scene_shape, config.pad)
        scene = part if scene is None else scene + part
    return scene


def _convolve(scene, kernel_rfft, config):
    if kernel_rfft is None:
        return scene
    return fft_ops.convolve_fft(scene, kernel_rfft, config.fft_shape,
                                (-2, -1))


def render(state, data, config):
    """Scene model convolved to the observed PSF."""
    scene = make_scene(state, config)
    if data.scene_mask is not None:
        scene = scene * data.scene_mask[..., None, :, :]
    return _convolve(scene, data.kernel_rfft, config)


# ---------------------------------------------------------------------------
# Morphology prox chain (one bucket, all components at once)
# ---------------------------------------------------------------------------
def _prox_morph_bucket(morphs, seds, data, config, b):
    """Box mask -> monotonicity -> background threshold (or positivity)
    -> center floor -> max normalization over bucket ``b``'s
    (…, Kb, hb, wb) stack.  Ref: lite/models.py:224-244."""
    hb, wb = config.box_shapes[b]
    bc = (hb // 2, wb // 2)

    if data.box_masks is not None:
        # confine each morphology to its logical (reference) box
        morphs = morphs * data.box_masks[b]

    # table of the brightest pixel near each center (first maximum wins)
    idx = kernels.candidate_index(morphs, config.fit_center_radius)
    morphs = kernels.monotonic_prox(
        morphs, idx, data.mono_weights[b], data.mono_keep[b],
        config.mono_n_iters[b], config.min_gradient, tol=config.mono_tol)

    if config.bg_thresh is not None:
        model = seds[..., :, None, None] * morphs[..., None, :, :]
        thresh = (config.bg_thresh * data.bg_rms)[..., None, :, None, None]
        cut = ~(model >= thresh).any(dim=-3)
        morphs = torch.where(cut, 0.0, morphs)
    else:
        morphs = torch.clamp_min(morphs, 0.0)

    # fresh tensor from the ops above: the in-place center write is local
    morphs[..., bc[0], bc[1]] = torch.clamp_min(morphs[..., bc[0], bc[1]],
                                                config.floor)
    return morphs / morphs.amax(dim=(-2, -1), keepdim=True)


def _cutoff(seds, data, config):
    """The packed branch's background threshold as a per-slot pixel
    cutoff ``min_c t_c / max(sed_c, floor)`` (..., K), 0 for the
    positivity clamp (scarlet_tpu/lite/engine.py:716-721): the any-band
    count of :func:`_prox_morph_bucket` in exact arithmetic, apart from
    it by roundoff at boundary pixels."""
    if config.bg_thresh is None:
        return seds.new_zeros(seds.shape[:-1])
    t_c = config.bg_thresh * data.bg_rms
    return (t_c[..., None, :]
            / torch.clamp_min(seds, config.floor)).amin(dim=-1)


def _morph_update(morphs, grads, opt, seds, gate, it, data, config, b,
                  hyper):
    """One bucket's morphology update: adaprox step, prox chain with the
    *new* SEDs ``seds`` (lite/models.py:246-252), slot gate ``gate``
    (…, K).  The branch is the JAX ``fit_step``'s for the same config
    (scarlet_tpu/lite/engine.py:842-1019).  Returns (morphs, moments)."""
    n_iter = config.mono_n_iters[b]
    tables = (data.mono_weights[b], data.mono_keep[b])
    masks = None if data.box_masks is None else data.box_masks[b]
    packed = packed_morphs_ok(config)
    if not packed and _fused_ok(config):
        damp = torch.where(it > 0, 1.0, 0.1).to(morphs.dtype)
        return kernels.fused_morph_update(
            morphs, grads, opt, gate, *tables, masks,
            _cutoff(seds, data, config), damp * config.morph_step, n_iter,
            config.min_gradient, config.fit_center_radius, config.b1,
            config.b2, config.eps, config.floor)

    stepped, mopt = adaprox_step(morphs, grads, it[..., None, None, None],
                                 opt, config.morph_step, prox=None, **hyper)
    gate3 = gate[..., None, None]
    mopt = AdaproxState(*(torch.where(gate3, new, old)
                          for new, old in zip(mopt, opt)))
    if not packed:
        proxed = _prox_morph_bucket(stepped, seds, data, config, b)
        return torch.where(gate3, proxed, morphs), mopt

    if masks is not None:
        stepped = stepped * masks
    idx = kernels.candidate_index(stepped, config.fit_center_radius)
    thr = _cutoff(seds, data, config)
    if config.packed_prox_chain:
        return kernels.prox_chain(morphs, stepped, idx, *tables, thr, gate,
                                  n_iter, config.min_gradient, config.floor,
                                  tol=config.mono_tol), mopt
    proxed = kernels.monotonic_prox(stepped, idx, *tables, n_iter,
                                    config.min_gradient, tol=config.mono_tol)
    return kernels.chain_epilogue(proxed, thr, gate, morphs,
                                  config.floor), mopt


# ---------------------------------------------------------------------------
# One fit iteration
# ---------------------------------------------------------------------------
def fit_step(state, data, config):
    """One adaprox iteration over all components of one blend, or of each
    blend of a batch.

    Returns (new_state, logL) with logL = -0.5 sum(w (model - img)^2) per
    blend (lite/models.py:541).
    """
    check_supported(config)
    C = config.scene_shape[0]

    scene = make_scene(state, config)
    if data.scene_mask is not None:
        # model flux clips at the true scene edge (zero-padded layouts)
        scene = scene * data.scene_mask[..., None, :, :]
    model = _convolve(scene, data.kernel_rfft, config)
    residual = data.weights * (model - data.images)
    logL = -0.5 * (residual * (model - data.images)).sum(dim=(-3, -2, -1))

    grad_scene = _convolve(residual, data.grad_kernel_rfft, config)
    if data.scene_mask is not None:
        grad_scene = grad_scene * data.scene_mask[..., None, :, :]
    # the JAX fit_step pads grad_scene by config.pad for the TPU's window
    # reads; grad_gather reads 0 outside the array, so it takes the
    # gradient unpadded and in place (a strided crop of the inverse FFT)

    it = state.it
    active = state.active
    n_bands = config.n_bands_total or C
    floor = config.floor
    hyper = dict(scheme=config.scheme, b1=config.b1, b2=config.b2,
                 eps=config.eps, p=config.p,
                 max_prox_iter=config.max_prox_iter)

    new_seds, new_sed_opts, new_morphs, new_morph_opts = [], [], [], []
    for b in range(config.n_buckets):
        seds_b = state.seds[b]
        morphs_b = state.morphs[b]
        on_b = state.comp_active[b]
        gate = active[..., None] & on_b                  # (…, K)

        g_seds, g_morphs = kernels.grad_gather(
            grad_scene, seds_b, morphs_b, state.origins[b], 0)

        # SED: relative step with a noise-floor minimum
        # (lite/initialization.py:275-279), floored by the prox
        sed_step = torch.maximum(
            data.sed_step_min[..., None, :],
            config.sed_step_factor * seds_b.sum(dim=-1, keepdim=True)
            / n_bands)
        sb, sopt = adaprox_step(
            seds_b, g_seds, it[..., None, None], state.sed_opt[b], sed_step,
            prox=lambda x, s: torch.clamp_min(x, floor),
            active=gate[..., None], param_dims=(-1,), **hyper)

        mb, mopt = _morph_update(morphs_b, g_morphs, state.morph_opt[b],
                                 sb, gate, it, data, config, b, hyper)
        new_morphs.append(mb)
        new_morph_opts.append(mopt)
        new_seds.append(sb)
        new_sed_opts.append(sopt)

    # convergence: |dL| < e_rel |L| after min_iter (lite/models.py:618)
    converged = (it > config.min_iter) & (
        (logL - state.last_loss).abs() < config.e_rel * logL.abs())
    new_state = BlendState(
        seds=tuple(new_seds),
        morphs=tuple(new_morphs),
        origins=state.origins,
        comp_active=state.comp_active,
        sed_opt=tuple(new_sed_opts),
        morph_opt=tuple(new_morph_opts),
        active=active & ~converged,
        it=it + active.to(it.dtype),
        last_loss=torch.where(active, logL, state.last_loss),
    )
    return new_state, logL


def fit_scan(state, data, config, n_iter):
    """Run ``n_iter`` fit iterations.  Returns (final_state, losses
    (n_iter, …)); converged blends keep their state and repeat their
    logL."""
    losses = []
    for _ in range(n_iter):
        state, logL = fit_step(state, data, config)
        losses.append(logL)
    if not losses:
        return state, state.last_loss.new_zeros((0,) + state.active.shape)
    return state, torch.stack(losses)
