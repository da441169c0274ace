"""Device-side batched initialization, fit and measurement of a stream of
blends: raw pixel stacks -> packed engine state -> records, on one device.

Port of ``scarlet_tpu/parallel/stream.py``:

    raw (B, C, H, W) stacks -> stream_setup -> (config, BlendData,
    BlendState, aux) -> fit_batch_device_converged -> stream_records

The initialization is a host recipe written over the (B, K) axes of a
chunk of blends and their catalog rows as tensor axes, with no per-blend
host work:

- ``recipe="main"``, ``lite.init_all_sources_main``: chi^2 coadd
  detection, SDSS symmetrization, exact weighted-monotonic projection
  (kernel ``monotonic_prox``, K1, with one centered table at tol 0),
  threshold trim, SNR-gated bulge/disk split with joint least-squares
  SEDs, PSF fallback; with ``use_mask=True`` the monotonic mask
  (``ops.prox.monotonic_mask_device``) replaces the projection and trim;
- ``recipe="wavelets"``, ``lite.init_all_sources_wavelets``: starlet
  detection dictionaries with the multiresolution support, each row's
  single, bulge and disk seeds masked by the monotonic mask in one
  batched call, boxes grown by ``grow``, the PSF gate, joint SEDs.

With ``centers=None`` the catalogs are detected on the stream's device
(``parallel.detection.detect_peaks_device``) from the sanitized stacks, and
``redetect=N`` adds N passes of detection on the fit's residuals, each
followed by a cold refit with the grown catalog.

The fit options of the engine pass through: logical box growth
(``box_grow``) and the scheduled projection tolerance
(``mono_tol_early``, ``mono_tol_switch``, ``mono_every``).  Every option
of the JAX stream runs here, the upload options too: ``upload="bulk"``,
``"overlap"`` or ``"auto"`` (one probe of the host -> device rate,
:func:`_upload_bandwidth_mbs`, picks one of the other two) and quantized
uploads (``upload_dtype=torch.bfloat16`` or ``torch.float16``: the
floating host stacks cross to the device in that type and are cast back
to float32 there, chunk by chunk).  Tests:
tests/test_torch_upload.py (against the JAX stream on the CPU) and
tests/test_torch_cuda.py (the quantized upload on the card).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from ..lite import engine
from ..ops import fft as fft_ops
from ..ops import kernels
from ..ops import prox as prox_ops
from ..ops import wavelet as wavelet_ops
from ..optim import AdaproxState
from .batch import (_SHARED_FIELDS, fit_batch_device_collect,
                    fit_batch_device_converged, fit_batch_device_dispatch)
from .detection import _masked_median_sigma, _ordered_sum, detect_peaks_device

__all__ = ["stream_setup", "stream_records", "deblend_device_stream"]

logger = logging.getLogger("scarlet_tpu_torch.parallel.stream")

TINY = 1e-20


def _centered_mono_table(S):
    """Single-candidate monotonicity table for an S x S box with the peak
    at its center (init-time projection): ``(w (1, 8, S, S), keep
    (1, S, S), depth)``, float32 numpy, memoized."""
    from ..cache import Cache

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


def _sanitize_host(images, variance):
    """:func:`_sanitize_stacks` on numpy stacks, in numpy (the JAX
    package's ``_sanitize_stacks(xp=np)``, so the same bits): the
    redetect passes quantize what this returns."""
    bad = ~(np.isfinite(images) & np.isfinite(variance)) | (variance < 0)
    zero = np.zeros((), images.dtype)
    images = np.where(bad, zero, images)
    vcnt = np.maximum(np.sum(~bad, axis=(-2, -1)), 1).astype(variance.dtype)
    vfill = (np.sum(np.where(bad, zero, variance), axis=(-2, -1))
             / vcnt)[..., None, None]
    return images, np.where(bad, vfill, variance)


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


def _wavelet_dictionaries(images, variance, scene_valid, n_scales,
                          bulge_scales):
    """The wavelet recipe's detection dictionaries of a chunk (B, H, W)
    each (stream.py:145-168 of the JAX package): the band sum's starlet
    coefficients, significance-masked by the multiresolution support and
    clipped at 0; detectlets sum every detail scale, bulgelets the first
    ``bulge_scales``, disklets the rest."""
    validb = scene_valid > 0.5
    detect_sum = torch.where(validb, _ordered_sum(images, 1), 0.0)
    sigma = _masked_median_sigma(variance, validb)
    coeffs = wavelet_ops.starlet_transform(detect_sum, scales=n_scales)
    M = wavelet_ops.multiresolution_support(coeffs, sigma, K=3, epsilon=1e-1,
                                            max_iter=20, valid=scene_valid)
    w = torch.clamp_min(M.to(images.dtype) * coeffs, 0.0)   # (B, J, H, W)
    return (_ordered_sum(w[:, :-1], 1), _ordered_sum(w[:, :bulge_scales], 1),
            _ordered_sum(w[:, bulge_scales:-1], 1))


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
                percentile, use_mask=False, recipe="main", grow=5,
                n_scales=5, bulge_scales=2, use_psf=True):
    """The initialization (stream.py:171-541 of the JAX package) of a
    chunk of B blends with K catalog rows each: the main recipe (with
    ``use_mask``, the monotonic mask's seeds instead of the projection and
    trim) or the wavelet recipe.  Returns (data_leaves, state_leaves, aux)
    with slot-packed tensors at the shared (S, n_slots) layout."""
    B, C, H, W = images.shape
    K = centers.shape[1]
    hS = S // 2
    dtype = images.dtype
    dev = images.device
    bi = torch.arange(B, device=dev)[:, None]
    wavelets = recipe == "wavelets"

    # --- observation-level quantities ------------------------------------
    n_valid = torch.clamp_min(scene_valid.sum(dim=(-2, -1)), 1.0)   # (B,)
    noise_rms = ((torch.sqrt(variance) * scene_valid[:, None]).sum(
        dim=(-2, -1)) / n_valid[:, None])                           # (B, C)
    if wavelets:
        detect, bulgelets, disklets = _wavelet_dictionaries(
            images, variance, scene_valid, n_scales, bulge_scales)
    else:
        detect = ((images / (noise_rms ** 2)[..., None, None]).sum(dim=1)
                  * scene_valid)                                   # (B,H,W)

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

    if wavelets:
        (prim_morph, prim_sed, prim_mask, disk, disk_sed, disk_mask, prim_on,
         disk_on, split, fallback) = _wavelet_seeds(
            dpad, bulgelets, disklets, detect[bi, cy1, cx1], snr, img_pk,
            conv_pk, sed_fb, psf_morph, psf_box_mask, center_on, images,
            kernel_rfft, cyc, cxc, S=S, fft_shape=fft_shape, min_snr=min_snr,
            grow=grow, use_psf=use_psf)
    else:
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

        if use_mask:
            # the monotonic mask (prox_monotonic_mask semantics), no
            # threshold trim
            centers_box = torch.full((B, K, 2), hS, dtype=torch.long,
                                     device=dev)
            on, m = prox_ops.monotonic_mask_device(d, centers_box)
            no_support = (on.sum(dim=(-2, -1)) <= 1) \
                & (m.amax(dim=(-2, -1)) <= 0)
        else:
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
        if use_mask:
            # project_morph_to_center: a center outside the support box
            # takes the smallest quantized box, not the PSF fallback
            size = torch.where(contains, size, 0)
        box_mask = _centered_box(_quantized_boxsize(size, S) // 2, S, dtype)
        m = m * box_mask
        morph_max = m.amax(dim=(-2, -1))                            # (B, K)
        fallback = (no_support if use_mask else ~contains) \
            | (morph_max <= 0)

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


def _wavelet_seeds(dpad, bulgelets, disklets, detect_pk, snr, img_pk,
                   conv_pk, sed_fb, psf_morph, psf_box_mask, center_on,
                   images, kernel_rfft, cyc, cxc, *, S, fft_shape, min_snr,
                   grow, use_psf):
    """The wavelet recipe's per-row seeds (stream.py:319-404 of the JAX
    package, ref lite/initialization.py:480-559) over the (B, K) axes:
    the monotonic mask of each dictionary's box, all three in one batched
    closure; the PSF gate, the bulge/disk split and the null rows; joint
    SEDs over the union of the two boxes, a component whose SED is all 0
    dropped ("cut bulge" / "cut disk")."""
    hS = S // 2
    B, K = snr.shape
    dtype = dpad.dtype
    dev = dpad.device
    pads = torch.stack([dpad, F.pad(bulgelets, (hS, hS, hS, hS)),
                        F.pad(disklets, (hS, hS, hS, hS))])  # (3, B, Hp, Wp)
    boxes = _windows(pads.movedim(0, 1), cyc, cxc, S, S)     # (B,K,3,S,S)
    centers_box = torch.full((B, K, 3, 2), hS, dtype=torch.long, device=dev)
    on, m = prox_ops.monotonic_mask_device(boxes, centers_box)
    no_support = (on.sum(dim=(-2, -1)) <= 1) & (m.amax(dim=(-2, -1)) <= 0)
    # project_morph_to_center's box: the mask's bounds grown by ``grow``,
    # centered and quantized (with the stop-side +1 of the Box bounds)
    y0, y1, x0, x1 = prox_ops.mask_extent(on)
    reach = torch.maximum(torch.maximum(hS - y0, y1 + 1 - hS),
                          torch.maximum(hS - x0, x1 + 1 - hS))
    bm = _centered_box(_quantized_boxsize(2 * (reach + grow), S) // 2, S,
                       dtype)
    m = m * bm
    mx = m.amax(dim=(-2, -1))
    morphs = m / torch.clamp_min(mx, TINY)[..., None, None]
    empty = no_support | (mx <= 0)                              # (B, K, 3)
    (morph1, bulge, disk), (bm1, bmB, bmD) = morphs.unbind(2), bm.unbind(2)
    no1, noB, noD = empty.unbind(2)

    nbr = torch.floor(snr) / min_snr
    psf_gate = ((nbr < 1) & bool(use_psf)) | (detect_pk <= 0)
    want_split = (nbr >= 2) & ~psf_gate
    split = want_split & ~noB & ~noD
    # both bulge and disk empty: a null source; exactly one empty: the
    # single-component seed; a single seed without support: null
    null_both = want_split & noB & noD
    single = ~psf_gate & ~split & ~null_both
    null = null_both | (single & no1)
    sed1 = _ratio_sed(img_pk, conv_pk)

    bulge_sed, disk_sed = _joint_seds(bulge, disk, torch.maximum(bmB, bmD),
                                      images, kernel_rfft, cyc, cxc,
                                      fft_shape)
    bulge_cut = ~(bulge_sed > 0).any(dim=-1)
    disk_cut = ~(disk_sed > 0).any(dim=-1)

    s3, g3 = split[..., None, None], psf_gate[..., None, None]
    prim_morph = torch.where(g3, psf_morph, torch.where(s3, bulge, morph1))
    prim_sed = torch.where(psf_gate[..., None], sed_fb,
                           torch.where(split[..., None], bulge_sed, sed1))
    prim_mask = torch.where(g3, psf_box_mask, torch.where(s3, bmB, bm1))
    prim_on = center_on & ~null & ~(split & bulge_cut)
    disk_on = center_on & split & ~disk_cut
    split = split & ~bulge_cut & ~disk_cut
    return (prim_morph, prim_sed, prim_mask, disk, disk_sed, bmD, prim_on,
            disk_on, split, psf_gate)


def _as_tensor(x, device, dtype=None):
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def stream_setup(images, variance, psfs, centers, model_psf, weights=None,
                 center_active=None, scene_valid=None, *, box_size, n_slots,
                 min_snr=50, thresh=0.5, percentile=25, bg_thresh=None,
                 e_rel=1e-4, min_iter=1, fft_shape=None, device=None,
                 use_mask=False, recipe="main", grow=5, wavelet_scales=5,
                 bulge_scales=2, use_psf=True, max_peaks=None,
                 detect_scales=3, box_grow=None, mono_tol=None,
                 mono_tol_early=0.0, mono_tol_switch=0, mono_every=1,
                 morph_step=None, min_gradient=0.0):
    """Batched device-side initialization of a chunk of blends.

    images, variance (B, C, H, W) and psfs (B, C, ph, pw): numpy arrays
    or tensors; centers (B, K, 2) integer (y, x) catalog rows (float rows
    are rounded), padded rows marked off in ``center_active`` (B, K).
    Rows outside the frame or on ``scene_valid == 0`` pixels are switched
    off.  ``centers=None`` detects the catalogs on the device from the
    sanitized stacks (:func:`detect_peaks_device`): ``max_peaks`` rows
    per blend (default ``n_slots``), ``detect_scales`` starlet scales;
    aux then also holds ``detected_peaks`` (the peaks found before the
    cut to ``max_peaks``), ``centers`` and ``center_active``.
    model_psf (1, mh, mw).  ``weights`` default to
    ``scene_valid / max(variance, 1e-12)``; non-finite pixels are zeroed
    out of images and weights.  ``box_size`` (odd) and ``n_slots`` set
    the shared layout.  ``device``: where the program runs (default: the
    images' device, the CUDA card for numpy inputs; ``"cpu"`` for the
    host).

    ``recipe``: "main" (with ``use_mask``, the monotonic-mask seeds) or
    "wavelets" (starlet dictionaries over ``wavelet_scales`` scales, at
    most what the physical (H, W) holds; bulge from the first
    ``bulge_scales``, disk from the rest but the coarse plane; mask boxes
    grown by ``grow``; ``use_psf`` gates rows below one component's S/N
    to the PSF seed).

    The config follows the JAX package's by device: on CUDA the
    accelerator branches (``use_pallas``, ``use_pallas_scene``,
    ``packed_morphs``) and ``mono_tol = 1e-3``; on the CPU none of them
    and ``mono_tol = 0``; ``conv_mode`` stays "fft" on both.

    Fit options (``engine.LiteFitConfig``): ``box_grow`` (the edge-pull
    threshold of logical box growth; the state then carries ``box_half``
    = -1 and ``step_scale`` = 1 per slot); ``mono_tol_early`` before
    iteration ``mono_tol_switch``, ``mono_tol`` after (no blend freezes
    before the switch); ``mono_every`` (the full projection only every
    N-th iteration; measured negative in the JAX package: keep 1).  The
    scheduled tolerance applies where the accelerator branches run.

    Returns (config, data, state, aux) for ``fit_batch_device_converged``,
    with aux the per-blend diagnostics ``n_active``, ``overflow``,
    ``slot_source``, ``snr``, ``split``, ``psf_fallback`` (and the
    detected catalog with ``centers=None``).
    """
    if recipe not in ("main", "wavelets"):
        raise ValueError(f"unknown recipe {recipe!r}")
    detect = centers is None
    if detect and center_active is not None:
        raise ValueError(
            "center_active only applies to a provided catalog; with "
            "centers=None the detector defines the active rows")
    S = int(box_size)
    if S % 2 == 0:
        raise ValueError(f"box_size must be odd, got {S}")
    device = default_device(device, images)
    engine.pin_float32(device)
    cuda = device.type == "cuda"

    images = _as_tensor(images, device, torch.float32)
    variance = _as_tensor(variance, device, torch.float32)
    psfs = _as_tensor(psfs, device, torch.float32)
    model_psf = _as_tensor(model_psf, device, torch.float32)
    B, C, H, W = images.shape
    has_valid = scene_valid is not None
    scene_valid = (images.new_ones((B, H, W)) if not has_valid
                   else _as_tensor(scene_valid, device, torch.float32))

    if fft_shape is None:
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

    # sanitize: a NaN pixel poisons the fit even at weight 0, so bad
    # pixels are zeroed, weighted 0 and given the band's mean variance
    images, variance, bad = _sanitize_stacks(images, variance)
    if weights is None:
        weights = (scene_valid[:, None] * torch.where(bad, 0.0, 1.0)
                   / torch.clamp_min(variance, 1e-12))
    else:
        weights = _as_tensor(weights, device, torch.float32)
        weights = torch.where(bad | ~torch.isfinite(weights), 0.0, weights)

    detected_peaks = None
    if detect:
        centers, center_active, detected_peaks = detect_peaks_device(
            images, variance, scene_valid if has_valid else None,
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
    # out-of-frame rows and rows on padding are switched off, like the
    # host recipe's skip list
    cy, cx = centers[..., 0].long(), centers[..., 1].long()
    in_bounds = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
    bi = torch.arange(B, device=device)[:, None]
    on_valid = scene_valid[bi, cy.clamp(0, H - 1), cx.clamp(0, W - 1)] > 0
    center_active = center_active & in_bounds & on_valid

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # the tables are uploaded once per box and device, not per chunk
    w8, keep_c = prox_ops.shared_tensors("stream_mono_center", S,
                                         (w8, keep_c), device)
    mono_w, mono_keep = prox_ops.shared_tensors(
        "monotonicity_tables_float32", ((S, S), 1, "angle"),
        (mono_w.astype(np.float32), mono_keep.astype(np.float32)), device)
    data_l, state_l, aux = _init_batch(
        images, variance, psfs, centers, center_active, model_psf,
        scene_valid, w8, keep_c, S=S, n_slots=int(n_slots),
        fft_shape=tuple(fft_shape), match_shape=match_shape,
        psf_fft_shape=psf_fft_shape, mono_iter=depth, min_snr=float(min_snr),
        thresh=float(thresh), percentile=float(percentile),
        use_mask=bool(use_mask), recipe=recipe, grow=int(grow),
        # the scale count is capped by the physical (H, W), as the host
        # caps it by its image's shape
        n_scales=wavelet_ops.get_scales((H, W), int(wavelet_scales)),
        bulge_scales=int(bulge_scales), use_psf=bool(use_psf))
    if detect:
        aux = dict(aux, detected_peaks=detected_peaks, centers=centers,
                   center_active=center_active)

    data = engine.BlendData(
        images=images, weights=weights,
        kernel_rfft=data_l["kernel_rfft"],
        grad_kernel_rfft=data_l["grad_kernel_rfft"],
        bg_rms=data_l["bg_rms"], sed_step_min=data_l["sed_step_min"],
        mono_weights=(mono_w,),
        mono_keep=(mono_keep,),
        box_masks=(data_l["box_masks"],),
        scene_mask=scene_valid if has_valid else None)
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
        last_loss=torch.full((B,), float("inf"), device=device),
        # box growth: -1 = still the init box
        box_half=None if box_grow is None else (
            torch.full((B, int(n_slots)), -1, dtype=torch.int32,
                       device=device),),
        step_scale=None if box_grow is None else (
            torch.ones((B, int(n_slots)), device=device),))

    config = engine.LiteFitConfig(
        scene_shape=(C, H, W), box_shapes=((S, S),),
        bucket_counts=(int(n_slots),), fft_shape=tuple(fft_shape),
        mono_n_iters=(int(fit_depth),), bg_thresh=bg_thresh,
        e_rel=float(e_rel), min_iter=int(min_iter), fit_center_radius=1,
        # the JAX stream's accelerator default: the projection exits at
        # max|delta| < 1e-3 (peak units); 0 = the exact fixed point
        mono_tol=(1e-3 if cuda else 0.0) if mono_tol is None
        else float(mono_tol),
        mono_tol_early=float(mono_tol_early),
        mono_tol_switch=int(mono_tol_switch),
        mono_every=int(mono_every),
        box_grow=None if box_grow is None else float(box_grow),
        morph_step=1e-2 if morph_step is None else float(morph_step),
        min_gradient=float(min_gradient),
        use_pallas=cuda, use_pallas_scene=cuda, packed_morphs=cuda,
        scene_pad=S // 2 + 2)
    return config, data, state, aux


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------
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


def _stream_weighted_flux(state, data, aux, config):
    """Observed-flux redistribution (lite/measure.py weight_sources
    semantics): each source's share of the observed flux is its convolved
    model over the total convolved model, capped at 1.  Per-band totals
    (B, K, C): one render per source, batched over the blends."""
    K = aux["snr"].shape[1]
    total = torch.clamp_min(engine.render(state, data, config), 0.0)
    imgs = data.images * (data.weights > 0)
    on = state.comp_active[0]
    src = aux["slot_source"]
    out = []
    for s in range(K):
        st = state._replace(comp_active=(on & (src == s),))
        conv_s = torch.clamp_min(engine.render(st, data, config), 0.0)
        ratio = torch.where(total > 0,
                            conv_s / torch.where(total > 0, total, 1.0), 0.0)
        out.append((torch.clamp_max(ratio, 1.0) * imgs).sum(dim=(-2, -1)))
    return torch.stack(out, dim=1)


def _to_host(tensors):
    """Device -> host copies of all ``tensors``, started together, then
    one synchronization: numpy arrays."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if any(t.device.type == "cuda" for t in tensors):
        torch.cuda.synchronize()
    return [h.numpy() for h in host]


def stream_records(state, losses, aux, data=None, config=None,
                   reweight=False):
    """Per-blend measurement records (host dicts) of a fitted stream
    batch; the reductions run where the state is.  ``reweight=True``
    (needs ``data`` and ``config``) reports the observed-flux
    redistribution of ``lite.measure.weight_sources`` instead of the raw
    model fluxes."""
    per_source, centroids, moments = _stream_records_device(state, aux)
    if reweight:
        if data is None or config is None:
            raise ValueError("reweight=True needs data and config")
        per_source = _stream_weighted_flux(state, data, aux, config)
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


# ---------------------------------------------------------------------------
# The one-call stream
# ---------------------------------------------------------------------------
def deblend_device_stream(images, variance, psfs, centers, model_psf,
                          weights=None, center_active=None, scene_valid=None,
                          *, box_size, n_slots, max_iter=100, check_every=25,
                          min_snr=50, e_rel=1e-4, reweight=False, chunk=None,
                          compact=None, upload_dtype=None, upload="bulk",
                          upload_bw_mbs=100.0, redetect=0,
                          redetect_radius=3.0, retry_overflow=False,
                          device=None, **kw):
    """One-call production path: device init, device fit and records for
    a stream of blends (stream.py:1035-1258 of the JAX package).

    ``chunk`` splits the stream into sub-batches, each initialized and fit
    in turn.  ``upload`` moves host (numpy) stacks to a CUDA ``device``:
    "bulk" copies each whole stack once, from pinned memory, before the
    first chunk; "overlap" stages chunk i+1's slices in pinned memory and
    copies them on a side stream while chunk i fits, ordered by events;
    "auto" times one 4 MB host -> device copy of the bulk path's kind
    (:func:`_upload_bandwidth_mbs`) and takes "overlap" below
    ``upload_bw_mbs`` MB/s, "bulk" above (logged).  Tensor inputs and
    single-chunk calls ignore it, and on the CPU there is no copy.
    ``upload_dtype`` (``torch.bfloat16`` or ``torch.float16``, or the
    names "bfloat16" and "float16") quantizes the floating host stacks
    (images, variance, psfs, weights, scene_valid) to that type for the
    transfer only, rounding to nearest even (``Tensor.to``, the rounding
    of the JAX package's ``astype``); each chunk's slices are cast back to
    float32 on the device before :func:`stream_setup`, which sanitizes
    after the cast.  Every program computes in float32; only the inputs
    are quantized, once (~0.4% per value for bfloat16), and that can flip
    discrete init decisions (SNR gates, boxes, splits) of marginal
    sources.  Tensor inputs are left as they are; the overflow retry
    reads the unquantized stacks, as the JAX stream's does after
    per-chunk uploads (after bulk ones it raises there).  ``compact`` (an
    iteration count or a list of them) runs every chunk to the first
    point, then only the still-active blends of all chunks as one
    residual batch (padded to 32 rows) to each next point and
    ``max_iter``.  ``retry_overflow`` re-initializes and refits
    the blends whose init wanted more than ``n_slots`` components at a
    larger slot count (in steps of 4) and splices their records back.
    ``centers=None`` detects each chunk's catalog on the device
    (``max_peaks=`` and ``detect_scales=`` go to :func:`stream_setup`).
    ``redetect=N`` runs N more passes (stream.py:1365-1471 of the JAX
    package): the fitted models are rendered and subtracted, peaks are
    detected on the residuals, those farther than ``redetect_radius`` px
    from every catalog row join the catalog (up to ``max_peaks`` rows),
    and the stream re-initializes and refits cold with it; the final
    aux entries carry the grown catalog as ``centers``/``center_active``.
    Other keywords go to :func:`stream_setup`.

    Returns (records, state, losses, aux); with ``chunk`` (and no
    ``compact``) state/losses/aux are per-chunk lists, with ``compact``
    they are merged; an overflow retry appends its own entry.
    """
    if upload not in ("bulk", "overlap", "auto"):
        raise ValueError(f"unknown upload mode {upload!r}")
    qdtype = _quant_dtype(upload_dtype)
    device = default_device(device, images)
    if redetect:
        return _deblend_redetect(
            images, variance, psfs, centers, model_psf, weights,
            center_active, scene_valid, box_size=box_size, n_slots=n_slots,
            max_iter=max_iter, check_every=check_every, min_snr=min_snr,
            e_rel=e_rel, reweight=reweight, chunk=chunk, compact=compact,
            qdtype=qdtype, redetect=int(redetect),
            redetect_radius=float(redetect_radius),
            retry_overflow=retry_overflow, device=device, kw=kw)

    B = len(images)
    if chunk is None or chunk >= B:
        spans = [slice(0, B)]
    else:
        spans = [slice(i, min(i + chunk, B)) for i in range(0, B, chunk)]
    host = not isinstance(images, torch.Tensor)
    mode = upload if host and len(spans) > 1 else "bulk"
    if mode == "auto":
        bw = _upload_bandwidth_mbs(device)
        mode = "overlap" if bw < float(upload_bw_mbs) else "bulk"
        logger.info("deblend_device_stream: measured %.1f MB/s idle upload "
                    "-> %s uploads", bw, mode)
    if device.type != "cuda":
        mode = "bulk"

    stacks = dict(images=images, variance=variance, psfs=psfs,
                  weights=weights, scene_valid=scene_valid)
    if mode == "bulk":
        stacks = {k: _upload(v, device, qdtype) for k, v in stacks.items()}
    else:
        copy_stream = torch.cuda.Stream(device)

    def dequantize(x):
        # quantized uploads compute in float32
        if x is None or qdtype is None or x.dtype != qdtype:
            return x
        return x.to(torch.float32)

    def chunk_args(sl):
        if mode == "bulk":
            return {k: None if v is None else v[sl]
                    for k, v in stacks.items()}, None
        staged = {k: None if v is None
                  else _host_stack(np.asarray(v)[sl], qdtype, pin=True)
                  for k, v in stacks.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: None if v is None else v.to(device, non_blocking=True)
                   for k, v in staged.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def sub(x, sl):
        return None if x is None else x[sl]

    if compact is None:
        points = ()
    elif np.isscalar(compact):
        points = (min(int(compact), max_iter),)
    else:
        points = tuple(sorted({min(int(c), max_iter) for c in compact}))
    if any(c <= 0 for c in points):
        raise ValueError(f"compact points must be positive, got {compact}")
    phase1 = points[0] if points else max_iter

    handles = []
    pre = chunk_args(spans[0])
    for i, sl in enumerate(spans):
        args, ready = pre
        if ready is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(ready)
            for t in args.values():
                if t is not None:
                    t.record_stream(cur)
        args = {k: dequantize(v) for k, v in args.items()}
        config, data, state, aux = stream_setup(
            args["images"], args["variance"], args["psfs"],
            sub(centers, sl), model_psf, weights=args["weights"],
            center_active=sub(center_active, sl),
            scene_valid=args["scene_valid"], box_size=box_size,
            n_slots=n_slots, min_snr=min_snr, e_rel=e_rel, device=device,
            **kw)
        if i + 1 < len(spans):
            pre = chunk_args(spans[i + 1])
        handle = fit_batch_device_dispatch(state, data, config, phase1,
                                           check_every=check_every)
        handles.append((handle, data, config, aux))

    if points and phase1 < max_iter:
        result = _collect_compacted(handles, points, max_iter, check_every,
                                    reweight)
    else:
        records, outs, losses_l, auxs = [], [], [], []
        for handle, data, config, aux in handles:
            out, losses = fit_batch_device_collect(handle, max_iter)
            records.extend(stream_records(out, losses, aux, data=data,
                                          config=config, reweight=reweight))
            outs.append(out)
            losses_l.append(losses)
            auxs.append(aux)
        if len(spans) == 1:
            result = records, outs[0], losses_l[0], auxs[0]
        else:
            result = records, outs, losses_l, auxs

    if retry_overflow:
        result = _retry_overflow(
            result, images, variance, psfs, centers, model_psf, weights,
            center_active, scene_valid, box_size=box_size, n_slots=n_slots,
            max_iter=max_iter, check_every=check_every, min_snr=min_snr,
            e_rel=e_rel, reweight=reweight, device=device, kw=kw)
    return result


# the types ``upload_dtype`` takes, by the names ``jnp.dtype`` knows them by
_UPLOAD_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _quant_dtype(upload_dtype):
    """``upload_dtype`` as a torch dtype (None: no quantization)."""
    if upload_dtype is None:
        return None
    if upload_dtype in _UPLOAD_DTYPES.values():
        return upload_dtype
    if isinstance(upload_dtype, str) and upload_dtype in _UPLOAD_DTYPES:
        return _UPLOAD_DTYPES[upload_dtype]
    raise ValueError(f"upload_dtype {upload_dtype!r}: one of "
                     f"{sorted(_UPLOAD_DTYPES)} or their torch dtypes")


def _host_stack(x, qdtype=None, pin=False):
    """A numpy stack as a CPU tensor, quantized to ``qdtype`` (rounded to
    nearest even) where it is floating, in pinned memory if ``pin``: one
    pass over the stack, none where nothing changes."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    dtype = qdtype if qdtype is not None and t.is_floating_point() \
        else t.dtype
    if pin:
        return torch.empty(t.shape, dtype=dtype, pin_memory=True).copy_(t)
    return t.to(dtype)


def _upload(x, device, qdtype=None):
    """One host -> device copy of a numpy stack (quantized to ``qdtype``
    where it is floating), from pinned memory on a CUDA device; tensors
    and None pass through."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    cuda = device.type == "cuda"
    t = _host_stack(x, qdtype, pin=cuda)
    return t.to(device, non_blocking=True) if cuda else t


def _upload_bandwidth_mbs(device, nbytes=4 << 20):
    """Idle host -> device rate (MB/s) of the bulk path's transfer
    (:func:`_upload`: a numpy buffer pinned, then copied): one full-size
    warm-up transfer, then one timed transfer of the same size, by the
    host clock up to ``torch.cuda.synchronize``.  The warm-up is full
    size because a link may ramp its bulk path only after a large
    transfer (JAX package, stream.py:59-79); on the CPU there is no
    transfer to time.  ``deblend_device_stream(upload="auto")`` reads
    it."""
    buf = np.zeros(nbytes, np.uint8)

    def put():
        _upload(buf, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    put()
    t0 = time.perf_counter()
    put()
    return nbytes / max(time.perf_counter() - t0, 1e-9) / 1e6


def _retry_overflow(result, images, variance, psfs, centers, model_psf,
                    weights, center_active, scene_valid, *, box_size,
                    n_slots, max_iter, check_every, min_snr, e_rel,
                    reweight, device, kw):
    """Re-run the slot-overflowed blends at a larger slot count
    (stream.py:1261-1330 of the JAX package): the subset, padded to a
    16-row bucket with all-inactive catalog rows, at a slot count
    quantized upward in steps of 4; its records replace the overflowed
    ones in stream order."""
    records, state, losses, aux = result
    auxs = aux if isinstance(aux, list) else [aux]
    host = _to_host([t for a in auxs for t in (a["n_active"],
                                                a["overflow"])])
    n_active, overflow = np.concatenate(host[0::2]), np.concatenate(host[1::2])
    idx = np.nonzero(overflow)[0]
    if idx.size == 0:
        return result

    need = int(n_active[idx].max())
    n_slots2 = n_slots + -(-(need - n_slots) // 4) * 4
    # the subset's catalog: the detected one when detection ran
    if centers is None:
        cat = _to_host([a[k] for k in ("centers", "center_active")
                        for a in auxs])
        sub_c = np.concatenate(cat[:len(auxs)])[idx]
        sub_a = np.concatenate(cat[len(auxs):])[idx]
    else:
        sub_c = _to_numpy(centers)[idx]
        sub_a = (np.ones(sub_c.shape[:2], bool) if center_active is None
                 else _to_numpy(center_active)[idx])

    # pad to a 16-row bucket by repeating row 0 with no active catalog row
    n_pad = -(-idx.size // 16) * 16
    idx_pad = np.concatenate(
        [idx, np.full(n_pad - idx.size, idx[0], idx.dtype)])
    sub_c = np.concatenate(
        [sub_c, np.repeat(sub_c[:1], n_pad - idx.size, axis=0)])
    sub_a = np.concatenate(
        [sub_a, np.zeros((n_pad - idx.size,) + sub_a.shape[1:], bool)])

    def take(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x[torch.from_numpy(idx_pad).to(x.device)]
        return np.asarray(x)[idx_pad]

    sub_records, sub_state, sub_losses, sub_aux = deblend_device_stream(
        take(images), take(variance), take(psfs), sub_c, model_psf,
        weights=take(weights), center_active=sub_a,
        scene_valid=take(scene_valid), box_size=box_size, n_slots=n_slots2,
        max_iter=max_iter, check_every=check_every, min_snr=min_snr,
        e_rel=e_rel, reweight=reweight, device=device, **kw)

    for pos, rec in zip(idx, sub_records):
        # "overflow" keeps meaning "overflowed the configured n_slots"
        rec["overflow"] = True
        rec["overflow_retried"] = True
        records[pos] = rec

    sub_aux = dict(sub_aux, retry_indices=idx, retry_n_slots=n_slots2,
                   centers=sub_c, center_active=sub_a)
    states = state if isinstance(state, list) else [state]
    losses_l = losses if isinstance(losses, list) else [losses]
    return (records, states + [sub_state], losses_l + [sub_losses],
            auxs + [sub_aux])


def _to_numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _union_catalogs(centers, active, det_c, det_a, radius, cap):
    """Per-blend union of a catalog with new detections (numpy, as in
    stream.py:1333-1362 of the JAX package): the catalog's active rows
    keep their order, new peaks (brightest first) join if farther than
    ``radius`` from every kept row, up to ``cap`` rows."""
    centers = _to_numpy(centers)
    active = (np.ones(centers.shape[:2], bool) if active is None
              else _to_numpy(active))
    B = centers.shape[0]
    merged = []
    for b in range(B):
        rows = [tuple(map(int, c)) for c in centers[b][active[b]]]
        for p in det_c[b][det_a[b]]:
            p = tuple(map(int, p))
            if len(rows) >= cap:
                break
            if all((p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 > radius ** 2
                   for q in rows):
                rows.append(p)
        merged.append(rows)
    K = max(1, max(len(r) for r in merged))
    out_c = np.zeros((B, K, 2), np.int32)
    out_a = np.zeros((B, K), bool)
    for b, rows in enumerate(merged):
        if rows:
            out_c[b, :len(rows)] = rows
            out_a[b, :len(rows)] = True
    return out_c, out_a


def _deblend_redetect(images, variance, psfs, centers, model_psf, weights,
                      center_active, scene_valid, *, box_size, n_slots,
                      max_iter, check_every, min_snr, e_rel, reweight, chunk,
                      compact, qdtype, redetect, redetect_radius,
                      retry_overflow, device, kw):
    """detect -> fit -> detect on the residuals -> refit, for
    ``deblend_device_stream(redetect=N)`` (stream.py:1365-1471 of the JAX
    package).  The stacks are uploaded once and sanitized once
    (stream_setup's re-sanitizing is then inert), so the residuals stay
    finite and every pass reads the same device copy; only the catalogs
    come back to the host, for :func:`_union_catalogs`.

    With ``qdtype`` and host stacks the JAX package sanitizes in numpy and
    each pass's fit reads the sanitized stacks quantized, while the
    residuals and their throwaway setup read them unquantized (as the
    overflow retry does here): the same numpy sanitizing, one upload of
    the float32 stacks (the residuals need them on the device) and one
    rounding of them to ``qdtype`` on the device, the host rounding's
    bits."""
    quantize = qdtype is not None and not isinstance(images, torch.Tensor) \
        and not isinstance(variance, torch.Tensor)
    if quantize:
        images, variance = _sanitize_host(np.ascontiguousarray(images),
                                          np.ascontiguousarray(variance))
    images, variance, psfs, weights, scene_valid = (
        None if x is None else _upload(x, device).to(device)
        for x in (images, variance, psfs, weights, scene_valid))
    images, variance = images.to(torch.float32), variance.to(torch.float32)
    if not quantize:
        images, variance, _ = _sanitize_stacks(images, variance)
    fit_stacks = dict(images=images, variance=variance, psfs=psfs,
                      weights=weights, scene_valid=scene_valid)
    if quantize:
        fit_stacks = {k: v.to(qdtype) if v is not None
                      and v.is_floating_point() else v
                      for k, v in fit_stacks.items()}
    cap = int(kw.get("max_peaks") or n_slots)
    scales = int(kw.get("detect_scales", 3))
    B = images.shape[0]
    spans = ([slice(0, B)] if chunk is None or chunk >= B
             else [slice(i, min(i + chunk, B)) for i in range(0, B, chunk)])

    def sub(x, sl):
        return None if x is None else x[sl]

    cur_c, cur_a = centers, center_active
    for pass_i in range(redetect + 1):
        out = deblend_device_stream(
            fit_stacks["images"], fit_stacks["variance"], fit_stacks["psfs"],
            cur_c, model_psf, weights=fit_stacks["weights"],
            center_active=cur_a, scene_valid=fit_stacks["scene_valid"],
            box_size=box_size, n_slots=n_slots, max_iter=max_iter,
            check_every=check_every, min_snr=min_snr, e_rel=e_rel,
            reweight=reweight, chunk=chunk, compact=compact,
            upload_dtype=qdtype if quantize else None, device=device, **kw)
        if pass_i == redetect:
            # the overflow retry applies once, on the final catalog and
            # the unquantized stacks
            if retry_overflow:
                out = _retry_overflow(
                    out, images, variance, psfs, cur_c, model_psf, weights,
                    cur_a, scene_valid, box_size=box_size, n_slots=n_slots,
                    max_iter=max_iter, check_every=check_every,
                    min_snr=min_snr, e_rel=e_rel, reweight=reweight,
                    device=device, kw=kw)
            records, state, losses, aux = out
            # the final aux entries carry the grown catalog
            cur_c = _to_numpy(cur_c)
            cur_a = (np.ones(cur_c.shape[:2], bool) if cur_a is None
                     else _to_numpy(cur_a))
            if not isinstance(aux, list):
                return records, state, losses, dict(
                    aux, centers=cur_c, center_active=cur_a)
            o, new_aux = 0, []
            for a in aux:
                if "retry_indices" in a:
                    # the retry entry indexes into the stream order (its
                    # rows past the indices are padding)
                    ri = a["retry_indices"]
                    new_aux.append(dict(a, centers=cur_c[ri],
                                        center_active=cur_a[ri]))
                    continue
                n = a["n_active"].shape[0]
                new_aux.append(dict(a, centers=cur_c[o:o + n],
                                    center_active=cur_a[o:o + n]))
                o += n
            return records, state, losses, new_aux
        records, state, losses, aux = out
        auxs = aux if isinstance(aux, list) else [aux]
        if cur_c is None:
            cat = _to_host([a[k] for k in ("centers", "center_active")
                            for a in auxs])
            cur_c = np.concatenate(cat[:len(auxs)])
            cur_a = np.concatenate(cat[len(auxs):])
        # detection on the residuals, per chunk: a throwaway setup of the
        # chunk renders its fitted state, as the JAX package does
        states = (state if isinstance(state, list)
                  else [engine.map_tree(lambda x, sl=sl: x[sl], state)
                        for sl in spans])
        found = []
        for sl, st in zip(spans, states):
            cfg_r, data_r, _, _ = stream_setup(
                images[sl], variance[sl], psfs[sl], sub(cur_c, sl),
                model_psf, weights=sub(weights, sl),
                center_active=sub(cur_a, sl),
                scene_valid=sub(scene_valid, sl), box_size=box_size,
                n_slots=n_slots, min_snr=min_snr, e_rel=e_rel,
                device=device, **kw)
            resid = images[sl] - engine.render(st, data_r, cfg_r)
            found.append(detect_peaks_device(
                resid, variance[sl], sub(scene_valid, sl), max_peaks=cap,
                scales=scales)[:2])
        det = _to_host([f[i] for i in (0, 1) for f in found])
        cur_c, cur_a = _union_catalogs(
            cur_c, cur_a, np.concatenate(det[:len(found)]),
            np.concatenate(det[len(found):]), redetect_radius, cap)


def _concat_trees(trees):
    return engine.map_tree(lambda *xs: torch.cat(xs, 0), *trees)


def _concat_data(datas):
    """Concatenate batched BlendData; the shared (config-determined)
    monotonicity tables come from the first chunk."""
    stacked = _concat_trees([
        d._replace(**{name: None for name in _SHARED_FIELDS})
        for d in datas])
    return stacked._replace(**{name: getattr(datas[0], name)
                               for name in _SHARED_FIELDS})


def _collect_compacted(handles, points, max_iter, check_every, reweight):
    """Convergence compaction (stream.py:1494-1555 of the JAX package):
    after ``points[0]`` iterations, the still-active blends of all chunks
    continue as one residual batch (padded to 32 rows), re-compacted at
    each further point until ``max_iter``.  The losses cover the first
    phase."""
    outs, datas, auxs, losses_l = [], [], [], []
    config = handles[0][2]
    for handle, data, cfg, aux in handles:
        out, losses = fit_batch_device_collect(handle, points[0])
        outs.append(out)
        datas.append(data)
        auxs.append(aux)
        losses_l.append(losses)

    state = _concat_trees(outs)
    data = _concat_data(datas)
    aux = {k: torch.cat([a[k] for a in auxs]) for k in auxs[0]}
    n_rows = max(l.shape[0] for l in losses_l)
    losses = torch.cat([F.pad(l, (0, 0, 0, n_rows - l.shape[0]))
                        for l in losses_l], dim=1)

    batched = data._replace(**{n: None for n in _SHARED_FIELDS})
    for lo, hi in zip(points, list(points[1:]) + [max_iter]):
        if hi <= lo:
            continue
        idx = torch.nonzero(state.active).reshape(-1)
        if not idx.numel():
            break
        n = idx.numel()
        n_res = -(-n // 32) * 32
        idx_pad = torch.cat([idx, idx[:1].expand(n_res - n)])
        take = lambda x: x[idx_pad]  # noqa: E731
        res_state = engine.map_tree(take, state)
        res_data = engine.map_tree(take, batched)._replace(
            **{k: getattr(data, k) for k in _SHARED_FIELDS})
        # padding rows are duplicates of a real blend: frozen
        pad_off = torch.arange(n_res, device=idx.device) < n
        res_state = res_state._replace(active=res_state.active & pad_off)
        res_out, _ = fit_batch_device_converged(res_state, res_data, config,
                                                hi - lo, check_every)

        def put(x, r):
            x = x.clone()
            x[idx] = r[:n]
            return x

        state = engine.map_tree(put, state, res_out)

    records = stream_records(state, losses, aux, data=data, config=config,
                             reweight=reweight)
    return records, state, losses, aux
