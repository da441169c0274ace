"""Frozen copy of the port's lite fit iteration (``lite/engine.py``):
the configuration, the state and data trees, the scene, the FFT
convolution, the adaprox updates and the morphology prox chain of both
branches, verbatim.  The kernels it calls are the plain versions
(``kernels.py`` here); a sharded band axis does not exist here, so the
band sum is the identity."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import fft as fft_ops
from . import kernels
from . import prox as prox_ops
from .optim import AdaproxState, adaprox_step, fista_step


def _band_sum(x, config):
    """The identity: this copy runs no band axis across ranks."""
    return x


@dataclass(frozen=True)
class LiteFitConfig:
    """Static fit configuration, field for field the JAX package's, so a
    config converts one to one (``dataclasses.asdict``).

    ``use_pallas``, ``use_pallas_scene``, ``packed_morphs``,
    ``packed_prox_chain`` and ``fuse_morph`` select the branch of the
    morphology update as in the JAX package (:func:`packed_morphs_ok`);
    the tensors' device picks kernel or plain version, and the layout is
    always (…, K, hb, wb).  ``pallas_interpret`` is carried for the
    conversion and changes nothing here; ``conv_precision`` is a name of
    ``ops.fft.PRECISION_PASSES`` (the matmul tier of ``conv_mode="dft"``).
    ``band_axis`` names a band process group (:func:`band_group`), as
    ``parallel.fit_batch_sharded`` sets it.
    """
    scene_shape: tuple            # (C, H, W)
    box_shapes: tuple             # ((hb, wb), ...) per bucket
    bucket_counts: tuple          # (Kb, ...) per bucket
    fft_shape: Optional[tuple]    # spatial FFT shape; None = no convolution
    mono_n_iters: tuple = ()      # per bucket; from monotonicity_tables
    optimizer: str = "adaprox"    # "adaprox" | "fista"
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
    # the scheduled tolerance (under use_pallas, read per blend on the
    # device): mono_tol_early before iteration mono_tol_switch, mono_tol
    # after, and no blend freezes before the switch; 0/0 = off
    mono_tol_early: float = 0.0
    mono_tol_switch: int = 0
    # the full projection only every N-th iteration (skip iterations exit
    # after one 4-pass block); measured negative in the JAX package
    # (scarlet_tpu/lite/engine.py:111-123): keep 1
    mono_every: int = 1
    # logical box growth: a slot whose next update pulls flux onto its box
    # edge by more than box_grow grows its mask by box_grow_step within
    # the physical box and halves its step; None = off
    box_grow: Optional[float] = None
    box_grow_step: int = 5
    neighbor_weight: str = "angle"
    use_pallas: bool = False
    use_pallas_scene: bool = False
    fuse_morph: bool = False      # fused morphology update (K6)
    packed_morphs: bool = False   # the packed branch (packed_morphs_ok)
    packed_prox_chain: bool = False  # its one-pass prox chain (K5)
    conv_mode: str = "fft"        # "fft" | "dft" (the folded matmul DFT)
    conv_precision: str = "float32"   # of the DFT: a PRECISION_PASSES name
    pallas_interpret: bool = False
    scene_pad: int = -1           # -1: one full (largest) box
    # the band axis of a sharded fit: its cross-band reductions sum over
    # the process group of this name (band_group); n_bands_total = the
    # global channel count
    band_axis: Optional[str] = None
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
    fista_step: Optional[tuple] = None  # per bucket: (…, Kb) base FISTA
    # steps (optimizer "fista")
    box_masks: Optional[tuple] = None   # per bucket: (…, Kb, hb, wb), 1
    # inside each component's logical box
    scene_mask: Optional[torch.Tensor] = None  # (…, H, W), 1 on real


class BlendState(NamedTuple):
    """Per-blend fit state; bucketed fields are tuples."""
    seds: tuple                  # per bucket: (…, Kb, C)
    morphs: tuple                # per bucket: (…, Kb, hb, wb)
    origins: tuple               # per bucket: (…, Kb, 2) int32
    comp_active: tuple           # per bucket: (…, Kb) bool
    sed_opt: tuple               # per bucket: AdaproxState | FistaState
    morph_opt: tuple             # per bucket: AdaproxState | FistaState
    active: torch.Tensor         # (…) bool: blend still iterating
    it: torch.Tensor             # (…) int32: iterations executed
    last_loss: torch.Tensor      # (…) float: previous logL
    # box growth (config.box_grow; None when off), per bucket:
    box_half: Optional[tuple] = None    # (…, Kb) int32 grown logical
    # half-size; -1 = still the init box (data.box_masks alone)
    step_scale: Optional[tuple] = None  # (…, Kb) float morphology step


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


def _fused_ok(config, grow):
    """Whether the JAX ``fit_step`` takes the fused morphology update
    (scarlet_tpu/lite/engine.py:937-943): adaprox only, and not while
    boxes grow."""
    return (config.use_pallas and config.fuse_morph
            and config.optimizer == "adaprox" and config.scheme == "amsgrad"
            and config.max_prox_iter <= 1 and config.band_axis is None
            and not grow)


def monotonicity_tables(box_shape, fit_center_radius=1,
                        neighbor_weight="angle"):
    """Stacked monotonicity weight tables for every candidate center in
    the (2r+1)^2 window around the box center (row-major, like
    ``argmax`` over the window).

    Returns numpy (weights (ncand, 8, hb, wb), keep (ncand, hb, wb),
    n_iter), memoized.
    """
    from .cache import Cache

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
    weights, keeps, n_iter = prox_ops.monotonic_tables(
        tuple(box_shape), neighbor_weight, centers)
    out = (weights, keeps.astype(np.float32), n_iter)
    Cache.set("monotonicity_tables", key, out)
    return out


def pin_float32(device):
    """Keep float32 contractions in full float32 on a CUDA ``device``:
    turn TF32 off for matmuls and cuDNN (cuDNN convolutions default to
    TF32).  Lower-precision contractions are known to change the
    reference's fitted solution, not only its last digits."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


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
    if config.conv_mode == "dft":
        ops = fft_ops.dft_conv_operators(scene.shape[-2:], config.fft_shape,
                                         scene.dtype, scene.device,
                                         config.conv_precision)
        return fft_ops.convolve_dft(scene, kernel_rfft, ops)
    return fft_ops.convolve_fft(scene, kernel_rfft, config.fft_shape,
                                (-2, -1))


def render(state, data, config):
    """Scene model convolved to the observed PSF."""
    scene = make_scene(state, config)
    if data.scene_mask is not None:
        scene = scene * data.scene_mask[..., None, :, :]
    return _convolve(scene, data.kernel_rfft, config)


def _grow_enabled(config, state):
    return (config.box_grow is not None and state.box_half is not None
            and config.optimizer == "adaprox")


def _box_offsets(hb, wb, bc, device):
    """(|dy| (hb, 1), |dx| (1, wb)) from the box center ``bc``."""
    dy = (torch.arange(hb, device=device) - bc[0]).abs()[:, None]
    dx = (torch.arange(wb, device=device) - bc[1]).abs()[None, :]
    return dy, dx


def _base_half(base_mask, bc):
    """Per slot, the logical half-size of the init box mask (…, K, hb, wb):
    the largest |offset| from the box center with mask support, (…, K)
    int32."""
    hb, wb = base_mask.shape[-2:]
    dy, dx = _box_offsets(hb, wb, bc, base_mask.device)
    on = base_mask > 0.5
    ry = torch.where(on.any(dim=-1), dy[:, 0], 0).amax(dim=-1)
    rx = torch.where(on.any(dim=-2), dx[0], 0).amax(dim=-1)
    return torch.maximum(ry, rx).to(torch.int32)


def _grown_mask_stack(base_mask, box_half, bc):
    """The effective logical mask: the init mask grown to the centered
    square of half-size ``box_half`` (…, K) (-1: the init mask alone)."""
    hb, wb = base_mask.shape[-2:]
    dy, dx = _box_offsets(hb, wb, bc, base_mask.device)
    h = box_half[..., None, None]
    inside = (dy <= h) & (dx <= h)
    return torch.maximum(base_mask, inside.to(base_mask.dtype))


def _edge_pull(x, m, v, step_k, h_eff, bc):
    """The reference's box-grow test (ref morphology.py:163-177) on
    (…, K, hb, wb) stacks: the magnitude of the next Adam update
    ``-m / v^(1/4) * step`` where the model has flux, averaged over each
    of the 4 edges of the current logical box (half-size ``h_eff``);
    returns each slot's largest edge mean (…, K).  As in the JAX package,
    pixels with v == 0 add 0 to the mean instead of leaving it (their m
    is 0 too)."""
    hb, wb = x.shape[-2:]
    dev = x.device
    dy = (torch.arange(hb, device=dev) - bc[0])[:, None]
    dx = (torch.arange(wb, device=dev) - bc[1])[None, :]
    h = h_eff[..., None, None]
    denom = torch.sqrt(torch.sqrt(torch.clamp_min(v, 0.0)))
    gu = torch.where(v > 0, -m / torch.clamp_min(denom, 1e-30), 0.0)
    pull = gu * step_k[..., None, None] * (x > 0)
    in_y = dy.abs() <= h
    in_x = dx.abs() <= h
    best = None
    for mask in ((dy == -h) & in_x, (dy == h) & in_x,
                 (dx == -h) & in_y, (dx == h) & in_y):
        mf = mask.to(x.dtype)
        e = (pull * mf).sum(dim=(-2, -1)) / torch.clamp_min(
            mf.sum(dim=(-2, -1)), 1.0)
        best = e if best is None else torch.maximum(best, e)
    return best


def _grow_update(config, b, morphs, mopt, base_h, box_half, step_scale,
                 gate):
    """The edge-pull trigger of one bucket after its update (the gated
    morphologies and moments): returns (box_half', step_scale').  A slot
    grows by ``box_grow_step`` and halves its step; growth stays inside
    the physical box."""
    hb, wb = config.box_shapes[b]
    bc = (hb // 2, wb // 2)
    h_eff = torch.maximum(base_h, box_half)
    step_k = (config.morph_step * step_scale).to(morphs.dtype)
    pull = _edge_pull(morphs, mopt.m, mopt.v, step_k, h_eff, bc)
    can = (h_eff + config.box_grow_step) <= min(bc)
    trig = (pull > config.box_grow) & can & gate
    new_half = torch.where(trig, h_eff + config.box_grow_step, box_half)
    new_scale = torch.where(trig, step_scale * 0.5, step_scale)
    return new_half.to(box_half.dtype), new_scale


def _mono_tol_arr(config, it):
    """The scheduled exit tolerance of each blend (float32, the shape and
    device of its iteration count ``it``), or None for the static
    ``config.mono_tol`` alone: the looser ``mono_tol_early`` before
    iteration ``mono_tol_switch``, ``mono_tol`` after; with ``mono_every >
    1`` the skip iterations (``it % mono_every != 0``) get 1e6, so the
    projection exits after one block.  Ref: scarlet_tpu/lite/engine.py:
    573-589."""
    def full(value):
        return torch.full(it.shape, value, dtype=torch.float32,
                          device=it.device)

    tol = None
    if config.mono_tol_switch > 0 and config.mono_tol_early > config.mono_tol:
        tol = torch.where(it < config.mono_tol_switch,
                          full(config.mono_tol_early), full(config.mono_tol))
    if config.mono_every > 1:
        base = full(config.mono_tol) if tol is None else tol
        # morphs are unit-peak, so 1e6 exceeds any possible |delta|
        tol = torch.where(it % config.mono_every == 0, base, full(1e6))
    return tol


def _projection_tol(config, it):
    """The projection's exit tolerance this iteration: under
    ``use_pallas``, the schedule's per-blend tensor or the static
    ``mono_tol``; the plain branch ignores both and runs at 0, as in
    scarlet_tpu/lite/engine.py:627-647."""
    if not config.use_pallas:
        return 0.0
    tol = _mono_tol_arr(config, it)
    return config.mono_tol if tol is None else tol


def _prox_morph_bucket(morphs, seds, data, config, b, tol, box_half=None):
    """Box mask -> monotonicity -> background threshold (or positivity)
    -> center floor -> max normalization over bucket ``b``'s
    (…, Kb, hb, wb) stack.  Ref: lite/models.py:224-244.

    ``tol`` is the projection's exit tolerance (:func:`_projection_tol`:
    0 on the plain branch, as the JAX plain branch ignores it).  Both
    branches run whole 4-pass blocks (the kernel's exit rule), where the
    JAX plain branch stops after exactly ``n_iter`` passes: at tol 0 the
    two agree whenever ``n_iter`` is at least the table's DAG depth (every
    config ``engine.monotonicity_tables`` builds) or a multiple of 4, so
    one kernel and one plain version serve both configs.  ``box_half``
    (…, Kb): the grown logical boxes (``box_grow``)."""
    hb, wb = config.box_shapes[b]
    bc = (hb // 2, wb // 2)

    if data.box_masks is not None:
        # confine each morphology to its logical (reference) box, grown
        # to the state's half-size with box_grow
        mask = data.box_masks[b]
        if box_half is not None:
            mask = _grown_mask_stack(mask, box_half, bc)
        morphs = morphs * mask

    # table of the brightest pixel near each center (first maximum wins)
    idx = kernels.candidate_index(morphs, config.fit_center_radius)
    morphs = kernels.monotonic_prox(
        morphs, idx, data.mono_weights[b], data.mono_keep[b],
        config.mono_n_iters[b], config.min_gradient, tol=tol)

    if config.bg_thresh is not None:
        model = seds[..., :, None, None] * morphs[..., None, :, :]
        thresh = (config.bg_thresh * data.bg_rms)[..., None, :, None, None]
        cut = ~_band_sum((model >= thresh).any(dim=-3), config)
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
                  hyper, tol, box_half=None, step_scale=None):
    """One bucket's adaprox morphology update: adaprox step, prox chain
    with the *new* SEDs ``seds`` (lite/models.py:246-252), slot gate
    ``gate`` (…, K).  The branch is the JAX ``fit_step``'s for the same
    config (scarlet_tpu/lite/engine.py:842-1019).  ``tol``: the
    projection's exit tolerance (the K5 chain keeps the static
    ``mono_tol``, as the JAX package's); ``box_half``/``step_scale``
    (…, K): box growth's masks and per-slot step scales.  Returns
    (morphs, moments)."""
    n_iter = config.mono_n_iters[b]
    tables = (data.mono_weights[b], data.mono_keep[b])
    masks = None if data.box_masks is None else data.box_masks[b]
    grow = box_half is not None
    if grow:
        hb, wb = config.box_shapes[b]
        masks = _grown_mask_stack(masks, box_half, (hb // 2, wb // 2))
    packed = packed_morphs_ok(config)
    if not packed and _fused_ok(config, grow):
        damp = torch.where(it > 0, 1.0, 0.1).to(morphs.dtype)
        return kernels.fused_morph_update(
            morphs, grads, opt, gate, *tables, masks,
            _cutoff(seds, data, config), damp * config.morph_step, n_iter,
            config.min_gradient, config.fit_center_radius, config.b1,
            config.b2, config.eps, config.floor)

    # the morphology step, per slot while boxes grow
    mstep = (config.morph_step * step_scale[..., None, None] if grow
             else config.morph_step)
    stepped, mopt = adaprox_step(morphs, grads, it[..., None, None, None],
                                 opt, mstep, prox=None, **hyper)
    gate3 = gate[..., None, None]
    mopt = AdaproxState(*(torch.where(gate3, new, old)
                          for new, old in zip(mopt, opt)))
    if not packed:
        proxed = _prox_morph_bucket(stepped, seds, data, config, b, tol,
                                    box_half)
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
                                    config.min_gradient, tol=tol)
    return kernels.chain_epilogue(proxed, thr, gate, morphs,
                                  config.floor), mopt


def _fista_bucket(seds_b, morphs_b, g_seds, g_morphs, sed_opt, morph_opt,
                  base, gate, it, data, config, b, tol):
    """One bucket's FISTA update (scarlet_tpu/lite/engine.py:796-819,
    992-1011, in that order): the SEDs step by ``base / |morph|^2`` of the
    old morphologies, floored; the morphologies' extrapolation ``y = z -
    step g`` steps by ``base / |sed|^2`` of the old SEDs, its prox is the
    bucket's chain with the new SEDs, and the acceleration starts from
    the morphologies before the step; slots off ``gate`` keep every
    field.  Returns (seds, sed_opt, morphs, morph_opt)."""
    floor = config.floor
    step = base / torch.clamp_min((morphs_b * morphs_b).sum(dim=(-2, -1)),
                                  1e-12)
    sb, sopt = fista_step(seds_b, g_seds, it, sed_opt, step[..., None],
                          prox=lambda x, s: torch.clamp_min(x, floor),
                          active=gate)
    mstep = base / torch.clamp_min(
        _band_sum((seds_b * seds_b).sum(dim=-1), config), 1e-12)
    mb, mopt = fista_step(
        morphs_b, g_morphs, it, morph_opt, mstep[..., None, None],
        prox=lambda y, s: _prox_morph_bucket(y, sb, data, config, b, tol),
        active=gate)
    return sb, sopt, mb, mopt


def fit_step(state, data, config):
    """One adaprox (or FISTA) iteration over all components of one blend,
    or of each blend of a batch.

    Returns (new_state, logL) with logL = -0.5 sum(w (model - img)^2) per
    blend (lite/models.py:541).
    """
    C = config.scene_shape[0]

    scene = make_scene(state, config)
    if data.scene_mask is not None:
        # model flux clips at the true scene edge (zero-padded layouts)
        scene = scene * data.scene_mask[..., None, :, :]
    model = _convolve(scene, data.kernel_rfft, config)
    residual = data.weights * (model - data.images)
    logL = _band_sum(
        -0.5 * (residual * (model - data.images)).sum(dim=(-3, -2, -1)),
        config)

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
    fista = config.optimizer == "fista"
    grow = _grow_enabled(config, state) and data.box_masks is not None
    tol = _projection_tol(config, it)

    new_seds, new_sed_opts, new_morphs, new_morph_opts = [], [], [], []
    new_halves, new_scales = [], []
    for b in range(config.n_buckets):
        seds_b = state.seds[b]
        morphs_b = state.morphs[b]
        on_b = state.comp_active[b]
        gate = active[..., None] & on_b                  # (…, K)

        g_seds, g_morphs = kernels.grad_gather(
            grad_scene, seds_b, morphs_b, state.origins[b], 0)
        g_morphs = _band_sum(g_morphs, config)

        if fista:
            sb, sopt, mb, mopt = _fista_bucket(
                seds_b, morphs_b, g_seds, g_morphs, state.sed_opt[b],
                state.morph_opt[b], data.fista_step[b], gate, it, data,
                config, b, tol)
        else:
            # SED: relative step with a noise-floor minimum
            # (lite/initialization.py:275-279), floored by the prox
            sed_step = torch.maximum(
                data.sed_step_min[..., None, :],
                config.sed_step_factor
                * _band_sum(seds_b.sum(dim=-1, keepdim=True), config)
                / n_bands)
            sb, sopt = adaprox_step(
                seds_b, g_seds, it[..., None, None], state.sed_opt[b],
                sed_step, prox=lambda x, s: torch.clamp_min(x, floor),
                active=gate[..., None], param_dims=(-1,), **hyper)
            mb, mopt = _morph_update(
                morphs_b, g_morphs, state.morph_opt[b], sb, gate, it, data,
                config, b, hyper, tol,
                box_half=state.box_half[b] if grow else None,
                step_scale=state.step_scale[b] if grow else None)
        if grow:
            hb, wb = config.box_shapes[b]
            nh, ns = _grow_update(
                config, b, mb, mopt,
                _base_half(data.box_masks[b], (hb // 2, wb // 2)),
                state.box_half[b], state.step_scale[b], gate)
            new_halves.append(nh)
            new_scales.append(ns)
        new_morphs.append(mb)
        new_morph_opts.append(mopt)
        new_seds.append(sb)
        new_sed_opts.append(sopt)

    # convergence: |dL| < e_rel |L| after min_iter (lite/models.py:618);
    # with the scheduled tolerance no blend freezes before the switch,
    # and with mono_every only on a full-projection iteration
    min_it = config.min_iter
    if config.mono_tol_switch > 0 and config.mono_tol_early > config.mono_tol:
        min_it = max(min_it, config.mono_tol_switch)
    converged = (it > min_it) & (
        (logL - state.last_loss).abs() < config.e_rel * logL.abs())
    if config.mono_every > 1:
        converged = converged & (it % config.mono_every == 0)
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
        box_half=tuple(new_halves) if grow else state.box_half,
        step_scale=tuple(new_scales) if grow else state.step_scale,
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
