"""Frozen copy of the port's device stream initialization and records
(``parallel/stream.py``) and of its segment loop
(``parallel/batch.py``), verbatim but for ``stream_setup``, which keeps
the main recipe with a catalog or with detection, and ``_init_batch``,
cut to the main recipe's projection and trim."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import engine
from . import fft as fft_ops
from . import kernels
from . import prox as prox_ops
from .detection import detect_peaks_device
from .optim import AdaproxState


TINY = 1e-20


def _centered_mono_table(S):
    """Single-candidate monotonicity table for an S x S box with the peak
    at its center (init-time projection): ``(w (1, 8, S, S), keep
    (1, S, S), depth)``, float32 numpy, memoized."""
    from .cache import Cache

    key = int(S)
    try:
        return Cache.check("stream_mono_center", key)
    except KeyError:
        pass
    c = (S // 2, S // 2)
    w = prox_ops.monotonic_weights((S, S), "angle", c).astype(np.float32)
    depth = prox_ops.monotonic_depth(w, (S, S), c)
    keep = np.zeros((S, S), np.float32)
    keep[c] = 1.0
    out = (w[None], keep[None], int(depth))
    Cache.set("stream_mono_center", key, out)
    return out


def _mono_project(x, w8, keep, depth):
    """Weighted-monotonic projection of (B, K, S, S) images about their
    centers to the exact fixed point: kernel ``monotonic_prox`` with the
    one centered table at tol 0, equal bit for bit to ``depth`` plain
    Jacobi passes (stream.py:103-117 of the JAX package)."""
    idx = torch.zeros(x.shape[:-2], dtype=torch.int32, device=x.device)
    return kernels.monotonic_prox(x.contiguous(), idx, w8, keep, depth, 0.0,
                                  tol=0.0)


def _sanitize_stacks(images, variance):
    """Zero non-finite pixels; give non-finite or negative variance the
    per-band mean of the finite variance.  Returns (images, variance,
    bad).  Bitwise inert on clean inputs."""
    bad = ~(torch.isfinite(images) & torch.isfinite(variance)) \
        | (variance < 0)
    images = torch.where(bad, 0.0, images)
    vcnt = torch.clamp_min((~bad).sum(dim=(-2, -1)), 1).to(variance.dtype)
    vfill = (torch.where(bad, 0.0, variance).sum(dim=(-2, -1))
             / vcnt)[..., None, None]
    variance = torch.where(bad, vfill, variance)
    return images, variance, bad


def _quantized_boxsize(size, cap, min_size=21, increment=10):
    """``initialization.get_minimal_boxsize`` on tensors: the smallest
    ``min_size + k * increment >= size``, capped at the physical box."""
    over = torch.clamp_min(size - min_size, 0)
    k = (over + increment - 1) // increment
    return torch.clamp_max(min_size + k * increment, cap)


def _windows(x, cy, cx, h, w):
    """The (h, w) windows of ``x`` (B, ..., Hx, Wx) with top-left corners
    (cy, cx) (B, K): (B, K, ..., h, w).  Corners must keep the window
    inside ``x``."""
    B = x.shape[0]
    dev = x.device
    xl = x.movedim((-2, -1), (1, 2))                   # (B, Hx, Wx, ...)
    rows = cy[..., None, None] + torch.arange(h, device=dev)[:, None]
    cols = cx[..., None, None] + torch.arange(w, device=dev)[None, :]
    bi = torch.arange(B, device=dev)[:, None, None, None]
    out = xl[bi, rows, cols]                           # (B, K, h, w, ...)
    return out.movedim((2, 3), (-2, -1))


def _corner(c, dim, size):
    """A window corner as the JAX program's dynamic slices and gathers
    take it: a negative index counts from the end, then the window is
    clamped inside the axis.  Only rows that are switched off (out of the
    frame) ever need it."""
    return torch.where(c < 0, c + dim, c).clamp(0, dim - size)


def _ratio_sed(num, den):
    """Peak-ratio SED; unusable bands (den <= 0, non-finite) seed 0."""
    r = torch.clamp_min(num / den, 0.0)
    return torch.where((den > 0) & torch.isfinite(r), r, 0.0)


def _convolve_shared(image, kernel_rfft, fft_shape):
    """Convolve (…, 1, H, W) images, identical across bands, with per-band
    kernel transforms (…, C, fh, fw//2+1): one forward transform per
    image, broadcast over the bands (the same values as transforming each
    band's copy)."""
    kimage = fft_ops.transform(image, fft_shape, (-2, -1))
    shape = tuple(image.shape[:-3]) + (kernel_rfft.shape[-3],) \
        + tuple(image.shape[-2:])
    return fft_ops.inverse_transform(kimage * kernel_rfft, fft_shape, shape,
                                     (-2, -1))


def _centered_box(half, S, dtype):
    """(…, S, S) masks of the centered boxes of half-size ``half`` (…)."""
    ridx = torch.arange(S, device=half.device) - S // 2
    h = half[..., None, None]
    return ((ridx[:, None].abs() <= h) & (ridx[None, :].abs() <= h)).to(dtype)


def _joint_seds(bulge, disk, bm, images, kernel_rfft, cyc, cxc, fft_shape):
    """Joint bulge/disk SEDs per band by 2x2 normal equations with a
    relative ridge (stream.py:286-314 of the JAX package): each morph
    (B, K, S, S) placed at its box corner (cyc, cxc) in a padded scene,
    convolved per band, cut back out and masked by ``bm``."""
    B, C, H, W = images.shape
    K, S = bulge.shape[1], bulge.shape[-1]
    hS = S // 2
    dev = images.device
    ridx = torch.arange(S, device=dev)
    pair = torch.stack([bulge, disk], 2)                     # (B,K,2,S,S)
    scene = images.new_zeros((B, K, 2, H + 2 * hS, W + 2 * hS))
    rows = cyc[..., None, None] + ridx[:, None]                 # (B,K,S,1)
    cols = cxc[..., None, None] + ridx[None, :]                 # (B,K,1,S)
    b5 = torch.arange(B, device=dev)[:, None, None, None]
    k5 = torch.arange(K, device=dev)[None, :, None, None]
    scene = scene.movedim(2, -1)
    scene[b5, k5, rows, cols] = pair.movedim(2, -1)
    scene = scene.movedim(-1, 2)[..., hS:hS + H, hS:hS + W]
    conv = _convolve_shared(scene[..., None, :, :],
                            kernel_rfft[:, None, None], fft_shape)
    conv = F.pad(conv, (hS, hS, hS, hS))             # (B, K, 2, C, Hp, Wp)
    cwin = _windows(conv.reshape(B * K, 2 * C, *conv.shape[-2:]),
                    cyc.reshape(B * K, 1), cxc.reshape(B * K, 1), S, S)
    cwin = cwin.reshape(B, K, 2, C, S, S)
    bm = bm[:, :, None]                                      # (B,K,1,S,S)
    A1 = cwin[:, :, 0] * bm
    A2 = cwin[:, :, 1] * bm
    ipad = F.pad(images, (hS, hS, hS, hS))
    y = _windows(ipad, cyc, cxc, S, S) * bm                   # (B,K,C,S,S)
    g11 = (A1 * A1).sum(dim=(-2, -1))
    g22 = (A2 * A2).sum(dim=(-2, -1))
    g12 = (A1 * A2).sum(dim=(-2, -1))
    r1 = (A1 * y).sum(dim=(-2, -1))
    r2 = (A2 * y).sum(dim=(-2, -1))
    # relative ridge: the solve stays finite when bulge == disk; an
    # all-zero pair (a null wavelet slot) has det clamped, numerators 0
    lam = 1e-6 * torch.maximum(g11, g22) + TINY
    g11 = g11 + lam
    g22 = g22 + lam
    det = torch.clamp_min(g11 * g22 - g12 * g12, TINY)
    return (torch.clamp_min((g22 * r1 - g12 * r2) / det, 0.0),
            torch.clamp_min((g11 * r2 - g12 * r1) / det, 0.0))


def _init_batch(images, variance, psfs, centers, center_on, model_psf,
                scene_valid, w8, keep_c, *, S, n_slots, fft_shape,
                match_shape, psf_fft_shape, mono_iter, min_snr, thresh,
                percentile):
    """The initialization (stream.py:171-541 of the JAX package) of a
    chunk of B blends with K catalog rows each: the main recipe.  Returns (data_leaves, state_leaves, aux)
    with slot-packed tensors at the shared (S, n_slots) layout."""
    B, C, H, W = images.shape
    K = centers.shape[1]
    hS = S // 2
    dtype = images.dtype
    dev = images.device
    bi = torch.arange(B, device=dev)[:, None]

    # --- observation-level quantities ------------------------------------
    n_valid = torch.clamp_min(scene_valid.sum(dim=(-2, -1)), 1.0)   # (B,)
    noise_rms = ((torch.sqrt(variance) * scene_valid[:, None]).sum(
        dim=(-2, -1)) / n_valid[:, None])                           # (B, C)
    detect = ((images / (noise_rms ** 2)[..., None, None]).sum(dim=1)
              * scene_valid)                                       # (B,H,W)

    # difference kernel (fft.match_psf semantics: the k-space ratio at the
    # PSF-matching shape, the kernel image at the PSF shape) and its rFFTs
    # at the fit shape
    kf = (fft_ops.transform(psfs, match_shape, (-2, -1))
          / fft_ops.transform(model_psf, match_shape, (-2, -1)))
    kimage = fft_ops.inverse_transform(kf, match_shape, tuple(psfs.shape),
                                       (-2, -1))
    kernel_rfft = fft_ops.transform(kimage, fft_shape, (-2, -1))
    grad_kernel_rfft = fft_ops.transform(torch.flip(kimage, (-2, -1)),
                                         fft_shape, (-2, -1))

    # detection image convolved to each band's seeing (peak SEDs)
    convolved = _convolve_shared(detect[:, None], kernel_rfft, fft_shape)

    # PSF SED: the model PSF convolved per band, its center pixel
    mh, mw = model_psf.shape[-2:]
    psf_krfft = fft_ops.transform(kimage, psf_fft_shape, (-2, -1))
    conv_psf = _convolve_shared(model_psf[None].expand(B, 1, mh, mw),
                                psf_krfft, psf_fft_shape)
    psf_sed = conv_psf[..., mh // 2, mw // 2]                       # (B, C)

    # PSF morphology seed, centered in the S x S box (center-cropped when
    # the PSF is larger)
    ch, cw = min(mh, S), min(mw, S)
    mp_crop = model_psf[0, (mh - ch) // 2:(mh - ch) // 2 + ch,
                        (mw - cw) // 2:(mw - cw) // 2 + cw]
    oy, ox = (S - ch) // 2, (S - cw) // 2
    psf_morph = images.new_zeros((S, S))
    psf_morph[oy:oy + ch, ox:ox + cw] = mp_crop / torch.clamp_min(
        mp_crop.max(), TINY)
    psf_box_mask = images.new_zeros((S, S))
    psf_box_mask[oy:oy + ch, ox:ox + cw] = 1.0

    # --- padded views for box extraction ----------------------------------
    ph, pw = psfs.shape[-2:]
    py, px = ph // 2, pw // 2
    dpad = F.pad(detect, (hS, hS, hS, hS))
    ipad_p = F.pad(images, (px, px, py, py))
    vpad_p = F.pad(variance, (px, px, py, py))

    cys = centers[..., 0].long()
    cxs = centers[..., 1].long()
    # box corners in the hS-padded views, and the centers' own pixels
    cyc, cxc = _corner(cys, H + 2 * hS, S), _corner(cxs, W + 2 * hS, S)
    cy1, cx1 = _corner(cys, H, 1), _corner(cxs, W, 1)

    # PSF-weighted peak S/N (lite/measure.py calculate_snr)
    cyp = _corner(cys, H + 2 * py, ph)
    cxp = _corner(cxs, W + 2 * px, pw)
    img_c = _windows(ipad_p, cyp, cxp, ph, pw)
    var_c = _windows(vpad_p, cyp, cxp, ph, pw)
    p4 = psfs[:, None]                                   # (B, 1, C, ph, pw)
    snr = ((img_c * p4).sum(dim=(-3, -2, -1))
           / torch.sqrt(torch.clamp_min(
               (p4 * var_c * p4).sum(dim=(-3, -2, -1)), TINY)))    # (B, K)
    img_pk = images[bi, :, cy1, cx1]                            # (B, K, C)
    conv_pk = convolved[bi, :, cy1, cx1]
    sed_fb = _ratio_sed(img_pk, psf_sed[:, None])

    thresh_val = noise_rms.mean(dim=-1) * thresh                # (B,)
    flux_thresh = torch.tensor(percentile / 100.0, dtype=dtype,
                               device=dev)
    split_snr = torch.floor(snr) / min_snr >= 2

    # centered S x S detection cutouts; SDSS symmetrization only where
    # a pixel and its mirror are both inside the image
    vpad = F.pad(scene_valid, (hS, hS, hS, hS))
    d = _windows(dpad, cyc, cxc, S, S)                      # (B,K,S,S)
    valid = _windows(vpad, cyc, cxc, S, S) > 0.5
    both = valid & torch.flip(valid, (-2, -1))
    d = torch.where(both, torch.minimum(d, torch.flip(d, (-2, -1))), d)

    # exact weighted-monotonic projection, then the threshold trim
    # (initialization.trim_morphology): sub-threshold pixels to
    # 0, the centered quantized logical box
    m = _mono_project(d, w8, keep_c, mono_iter)
    m = torch.where(m > thresh_val[:, None, None, None], m, 0.0)
    on = m > 0
    y0, y1, x0, x1 = prox_ops.mask_extent(on)
    contains = (y0 <= hS) & (hS <= y1) & (x0 <= hS) & (hS <= x1)
    # trim_morphology's size, with the stop-side +1 of the Box bounds
    size = 2 * torch.maximum(torch.maximum(hS - y0, y1 + 1 - hS),
                             torch.maximum(hS - x0, x1 + 1 - hS))
    box_mask = _centered_box(_quantized_boxsize(size, S) // 2, S, dtype)
    m = m * box_mask
    morph_max = m.amax(dim=(-2, -1))                            # (B, K)
    fallback = ~contains | (morph_max <= 0)

    # peak SED from the image / convolved-detection ratio
    sed = _ratio_sed(img_pk, conv_pk) * morph_max[..., None]
    morph = m / torch.clamp_min(morph_max, TINY)[..., None, None]

    # PSF fallback
    fb3 = fallback[..., None, None]
    morph = torch.where(fb3, psf_morph, morph)
    sed = torch.where(fallback[..., None], sed_fb, sed)
    box_mask = torch.where(fb3, psf_box_mask, box_mask)

    # bulge/disk split candidates (percentile/100 flux threshold)
    disk = torch.minimum(morph, flux_thresh)
    bulge = torch.clamp_min(morph - flux_thresh, 0.0)
    bmax = bulge.amax(dim=(-2, -1))
    dmax = disk.amax(dim=(-2, -1))
    split = split_snr & ~fallback & (bmax > 0) & (dmax > 0)
    bulge = bulge / torch.clamp_min(bmax, TINY)[..., None, None]
    disk = disk / torch.clamp_min(dmax, TINY)[..., None, None]

    bulge_sed, disk_sed = _joint_seds(bulge, disk, box_mask, images,
                                      kernel_rfft, cyc, cxc, fft_shape)
    s3 = split[..., None, None]
    prim_morph = torch.where(s3, bulge, morph)
    prim_sed = torch.where(split[..., None], bulge_sed, sed)
    prim_mask = disk_mask = box_mask
    prim_on = center_on
    disk_on = center_on & split

    # --- slot packing: (bulge | single, disk) interleaved, compacted -------
    origins_k = torch.stack([cys - hS, cxs - hS], dim=-1).to(torch.int32)
    seds2 = torch.stack([prim_sed, disk_sed], 2).reshape(B, 2 * K, C)
    morphs2 = torch.stack([prim_morph, disk], 2).reshape(B, 2 * K, S, S)
    bmask2 = torch.stack([prim_mask, disk_mask], 2).reshape(B, 2 * K, S, S)
    origins2 = torch.stack([origins_k, origins_k], 2).reshape(B, 2 * K, 2)
    active2 = torch.stack([prim_on, disk_on], 2).reshape(B, 2 * K)
    source2 = torch.arange(K, device=dev).repeat_interleave(2).expand(B,
                                                                     2 * K)

    order = torch.argsort((~active2).to(torch.int8), dim=1,
                          stable=True)[:, :n_slots]
    on_s = active2[bi, order]
    # inactive slots' seds and morphs zeroed with where, never a multiply
    # (a non-finite value times 0 stays non-finite)
    seds_s = torch.where(on_s[..., None], seds2[bi, order], 0.0)
    morphs_s = torch.where(on_s[..., None, None], morphs2[bi, order], 0.0)
    data_leaves = dict(
        kernel_rfft=kernel_rfft, grad_kernel_rfft=grad_kernel_rfft,
        bg_rms=noise_rms, sed_step_min=noise_rms / 10.0,
        box_masks=bmask2[bi, order])
    state_leaves = dict(seds=seds_s, morphs=morphs_s,
                        origins=origins2[bi, order], comp_active=on_s)
    n_active = active2.sum(dim=1, dtype=torch.int32)
    aux = dict(n_active=n_active, overflow=n_active > n_slots,
               slot_source=torch.where(on_s, source2[bi, order], -1),
               snr=snr, split=split, psf_fallback=fallback)
    return data_leaves, state_leaves, aux


def _as_tensor(x, device, dtype=None):
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def stream_setup(images, variance, psfs, centers, model_psf,
                 center_active=None, *, box_size, n_slots, min_snr=50,
                 thresh=0.5, percentile=25, e_rel=1e-4, device,
                 max_peaks=None, detect_scales=3):
    """The port's ``stream_setup`` for its main recipe, with a catalog
    (``centers``, ``center_active``) or with detection on the device
    (``centers=None``): sanitize, weights ``1 / max(variance, 1e-12)``,
    init, slot packing, and the fit's configuration, whose branches and
    projection tolerance follow the device as the port's do (on CUDA the
    kernels' branches at ``mono_tol = 1e-3``, run here by their plain
    versions; on the CPU the plain branch at 0).  Returns (config, data,
    state, aux) as the port's."""
    detect = centers is None
    S = int(box_size)
    device = torch.device(device)
    engine.pin_float32(device)
    cuda = device.type == "cuda"

    images = _as_tensor(images, device, torch.float32)
    variance = _as_tensor(variance, device, torch.float32)
    psfs = _as_tensor(psfs, device, torch.float32)
    model_psf = _as_tensor(model_psf, device, torch.float32)
    B, C, H, W = images.shape
    scene_valid = images.new_ones((B, H, W))

    fft_shape = fft_ops.minimal_same_fft_shape(
        (C, H, W), tuple(psfs.shape[1:]), axes=(1, 2))
    match_shape = tuple(fft_ops.good_fft_shape(
        tuple(psfs.shape[1:]), tuple(model_psf.shape), padding=3,
        axes=(-2, -1)))
    psf_fft_shape = tuple(fft_ops.good_fft_shape(
        tuple(model_psf.shape), tuple(psfs.shape[1:]), padding=3,
        axes=(-2, -1)))

    w8, keep_c, depth = _centered_mono_table(S)
    mono_w, mono_keep, fit_depth = engine.monotonicity_tables(
        (S, S), 1, "angle")

    images, variance, bad = _sanitize_stacks(images, variance)
    weights = (scene_valid[:, None] * torch.where(bad, 0.0, 1.0)
               / torch.clamp_min(variance, 1e-12))

    detected_peaks = None
    if detect:
        centers, center_active, detected_peaks = detect_peaks_device(
            images, variance, None,
            max_peaks=int(n_slots if max_peaks is None else max_peaks),
            scales=int(detect_scales))
    else:
        centers = _as_tensor(centers, device)
        if centers.is_floating_point():
            centers = torch.round(centers)
        centers = centers.to(torch.int32)
        center_active = (torch.ones(centers.shape[:2], dtype=torch.bool,
                                    device=device) if center_active is None
                         else _as_tensor(center_active, device, torch.bool))
    cy, cx = centers[..., 0].long(), centers[..., 1].long()
    in_bounds = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
    bi = torch.arange(B, device=device)[:, None]
    on_valid = scene_valid[bi, cy.clamp(0, H - 1), cx.clamp(0, W - 1)] > 0
    center_active = center_active & in_bounds & on_valid

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    w8, keep_c = dev_t(w8), dev_t(keep_c)
    mono_w = dev_t(mono_w.astype(np.float32))
    mono_keep = dev_t(mono_keep.astype(np.float32))
    data_l, state_l, aux = _init_batch(
        images, variance, psfs, centers, center_active, model_psf,
        scene_valid, w8, keep_c, S=S, n_slots=int(n_slots),
        fft_shape=tuple(fft_shape), match_shape=match_shape,
        psf_fft_shape=psf_fft_shape, mono_iter=depth, min_snr=float(min_snr),
        thresh=float(thresh), percentile=float(percentile))
    if detect:
        aux = dict(aux, detected_peaks=detected_peaks, centers=centers,
                   center_active=center_active)

    data = engine.BlendData(
        images=images, weights=weights,
        kernel_rfft=data_l["kernel_rfft"],
        grad_kernel_rfft=data_l["grad_kernel_rfft"],
        bg_rms=data_l["bg_rms"], sed_step_min=data_l["sed_step_min"],
        mono_weights=(mono_w,), mono_keep=(mono_keep,),
        box_masks=(data_l["box_masks"],), scene_mask=None)
    zero_sed = torch.zeros_like(state_l["seds"])
    zero_mor = torch.zeros_like(state_l["morphs"])
    state = engine.BlendState(
        seds=(state_l["seds"],), morphs=(state_l["morphs"],),
        origins=(state_l["origins"],),
        comp_active=(state_l["comp_active"],),
        sed_opt=(AdaproxState(zero_sed, zero_sed, zero_sed),),
        morph_opt=(AdaproxState(zero_mor, zero_mor, zero_mor),),
        active=torch.ones(B, dtype=torch.bool, device=device),
        it=torch.zeros(B, dtype=torch.int32, device=device),
        last_loss=torch.full((B,), float("inf"), device=device))

    config = engine.LiteFitConfig(
        scene_shape=(C, H, W), box_shapes=((S, S),),
        bucket_counts=(int(n_slots),), fft_shape=tuple(fft_shape),
        mono_n_iters=(int(fit_depth),), bg_thresh=None,
        e_rel=float(e_rel), min_iter=1, fit_center_radius=1,
        mono_tol=1e-3 if cuda else 0.0, morph_step=1e-2,
        use_pallas=cuda, use_pallas_scene=cuda, packed_morphs=cuda,
        scene_pad=S // 2 + 2)
    return config, data, state, aux



def _segment_sum(values, src, n):
    """Sum (B, n_slots, ...) ``values`` into (B, n, ...) by slot source
    ``src`` (B, n_slots); rows with ``src >= n`` are dropped.  An explicit
    one-hot sum in float32: a source has at most two slots, so the sum is
    the same in any order."""
    onehot = (src[..., None] == torch.arange(n, device=src.device)).to(
        values.dtype)                                    # (B, n_slots, n)
    v = values.reshape(*values.shape[:2], 1, -1)
    out = (onehot[..., None] * v).sum(dim=1)             # (B, n, F)
    return out.reshape(values.shape[:1] + (n,) + values.shape[2:])


def _stream_records_device(state, aux):
    """Per-source model fluxes (B, K, C), intensity-weighted centroids
    (B, K, 2) in scene coordinates and flux-normalized central second
    moments (sigma_yy, sigma_xx, sigma_xy) (B, K, 3) of the channel-summed
    model (stream.py:864-949 of the JAX package).  Explicit float32 sums,
    no matrix products."""
    seds = state.seds[0]                    # (B, n_slots, C)
    morphs = state.morphs[0]                # (B, n_slots, hb, wb)
    on = state.comp_active[0]
    origins = state.origins[0].to(morphs.dtype)
    K = aux["snr"].shape[1]
    src = torch.where(on, aux["slot_source"].long(), K)
    msum = morphs.sum(dim=(-2, -1))
    flux = seds * msum[..., None] * on[..., None]
    per_source = _segment_sum(flux, src, K)

    iy = torch.arange(morphs.shape[-2], dtype=morphs.dtype,
                      device=morphs.device)
    ix = torch.arange(morphs.shape[-1], dtype=morphs.dtype,
                      device=morphs.device)
    m1y = (morphs * iy[:, None]).sum(dim=(-2, -1))
    m1x = (morphs * ix).sum(dim=(-2, -1))
    m2y = (morphs * (iy * iy)[:, None]).sum(dim=(-2, -1))
    m2x = (morphs * (ix * ix)).sum(dim=(-2, -1))
    mxy = (morphs * iy[:, None] * ix).sum(dim=(-2, -1))
    denom = torch.where(msum != 0, msum, 1.0)
    cy = m1y / denom + origins[..., 0]
    cx = m1x / denom + origins[..., 1]
    wslot = flux.sum(dim=-1)                               # (B, n_slots)
    wsum = _segment_sum(wslot, src, K)                     # (B, K)
    wsafe = torch.where(wsum != 0, wsum, 1.0)
    cen_y = _segment_sum(wslot * cy, src, K) / wsafe
    cen_x = _segment_sum(wslot * cx, src, K) / wsafe
    # a source with no active slot has no centroid: NaN, not (0, 0)
    centroid = torch.where(wsum[..., None] != 0,
                           torch.stack([cen_y, cen_x], dim=-1), float("nan"))

    # central moments: each slot centralized about its source's centroid
    # before squaring (|origin - centroid| is O(box), not O(scene))
    sedsum = torch.where(msum != 0, wslot / denom, 0.0)
    src_c = src.clamp_max(K - 1)
    ceny_s = torch.gather(cen_y, 1, src_c)
    cenx_s = torch.gather(cen_x, 1, src_c)
    ceny_s = torch.where(torch.isfinite(ceny_s), ceny_s, 0.0)
    cenx_s = torch.where(torch.isfinite(cenx_s), cenx_s, 0.0)
    dy0 = origins[..., 0] - ceny_s
    dx0 = origins[..., 1] - cenx_s
    cy2 = m2y + 2 * dy0 * m1y + dy0 * dy0 * msum
    cx2 = m2x + 2 * dx0 * m1x + dx0 * dx0 * msum
    cxy = mxy + dy0 * m1x + dx0 * m1y + dy0 * dx0 * msum
    moments = torch.stack([_segment_sum(sedsum * c, src, K) / wsafe
                           for c in (cy2, cx2, cxy)], dim=-1)
    moments = torch.where(wsum[..., None] != 0, moments, float("nan"))
    return per_source, centroid, moments


def _to_host(tensors):
    """Device -> host copies of all ``tensors``, started together, then
    one synchronization: numpy arrays."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if any(t.device.type == "cuda" for t in tensors):
        torch.cuda.synchronize()
    return [h.numpy() for h in host]


def stream_records(state, losses, aux):
    """Per-blend measurement records (host dicts) of a fitted stream
    batch, with the raw model fluxes; the reductions run where the state
    is."""
    per_source, centroids, moments = _stream_records_device(state, aux)
    (per_source, centroids, moments, its, last, comp_on, snr, overflowed,
     losses) = _to_host([per_source, centroids, moments, state.it,
                         state.last_loss, state.comp_active[0], aux["snr"],
                         aux["overflow"], losses])
    n_act = comp_on.sum(axis=1)
    overflowed = overflowed.reshape(-1)
    records = []
    for b in range(per_source.shape[0]):
        records.append({
            "iterations": int(its[b]),
            "logL": float(last[b]),
            "init logL": float(losses[0, b]) if losses.size else float("nan"),
            "n_components": int(n_act[b]),
            # init wanted more components than the slot layout holds
            "overflow": bool(overflowed[b]),
            "flux": per_source[b],
            "centroid": centroids[b],
            "moments": moments[b],
            "snr": snr[b],
        })
    return records



def fit_batch_device_converged(state, data, config, max_iter,
                               check_every=10):
    """Fit until every blend has converged, or ``max_iter`` iterations.

    Runs segments of ``check_every`` iterations and reads
    ``state.active.any()`` on the host once per segment; the last
    ``max_iter % check_every`` iterations run as a tail, so the count stops
    exactly at the cap.  Returns (final_state, losses (n_run, B)) for the
    ``n_run`` iterations executed; converged blends repeat their logL.
    """
    check_every = min(check_every, max_iter)
    n_full = max_iter // check_every
    rem = max_iter - n_full * check_every
    losses = []
    done = 0
    while done < n_full and bool(state.active.any()):
        state, seg = engine.fit_scan(state, data, config, check_every)
        losses.append(seg)
        done += 1
    if rem and bool(state.active.any()):
        state, seg = engine.fit_scan(state, data, config, rem)
        losses.append(seg)
    if not losses:
        return state, state.last_loss.new_zeros((0,) + state.active.shape)
    return state, torch.cat(losses)
