"""Frozen copy of the port's device detection
(``parallel/detection.py``), verbatim."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import wavelet as wavelet_ops


LABEL_SWEEPS = 4


def _shift_fill(x, dy, dx, fill):
    """``out[..., y, x] = x[..., y + dy, x + dx]``, ``fill`` outside the
    frame; dy, dx in {-1, 0, 1}."""
    H, W = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1), value=fill)
    return padded[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _label_pass(lab, pos, sent):
    """One labelling sweep over (B, H, W) labels: the 4-neighbour minimum,
    then two pointer-jumping hops (a label is a flat pixel index, so a
    gather hops to the label of the pixel it points at).  ``sent`` = H*W
    marks the background."""
    m = lab
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        m = torch.minimum(m, _shift_fill(lab, dy, dx, sent))
    flat = torch.where(pos, m, sent).flatten(1)
    for _ in range(2):
        hop = flat.gather(1, flat.clamp_max(sent - 1))
        flat = torch.where(flat < sent, torch.minimum(flat, hop), sent)
    return flat.reshape(lab.shape)


def label_components_device(pos):
    """4-connected component labels of a boolean (..., H, W) mask.

    Returns (..., H, W) int64: every pixel of a component carries the
    component's smallest flat index; background pixels carry H*W.  The
    partition is ``scipy.ndimage.label``'s with the plus-shaped structure
    (ref detect_pybind11.cc:61-124's flood fill)."""
    lead = pos.shape[:-2]
    H, W = pos.shape[-2:]
    pos = pos.reshape(-1, H, W)
    sent = H * W
    idx = torch.arange(sent, device=pos.device).reshape(H, W)
    lab = torch.where(pos, idx, sent)
    while True:
        for _ in range(LABEL_SWEEPS - 1):
            lab = _label_pass(lab, pos, sent)
        new = _label_pass(lab, pos, sent)
        changed = bool((new != lab).any())
        label_components_device.host_syncs += 1
        lab = new
        if not changed:
            return lab.reshape(*lead, H, W)


def _masked_median_sigma(variance, validb):
    """Per blend, the median of sqrt(variance) over the valid pixels of
    all bands: the host's ``np.median(np.sqrt(variance))`` (ref
    detect.py:424) with zero-padded crops left out.  variance (B, C, H,
    W), validb (B, H, W) -> (B,)."""
    B, C = variance.shape[:2]
    sq = torch.where(validb[:, None], torch.sqrt(variance),
                     float("inf")).reshape(B, -1)
    flat = torch.sort(sq, dim=-1).values
    n = flat.shape[-1]
    nv = C * validb.flatten(1).sum(dim=1)
    # an index of -1 (no valid pixel) reads the last element, as in JAX
    lo = torch.remainder((nv - 1) // 2, n)[:, None]
    hi = torch.remainder(nv // 2, n)[:, None]
    return 0.5 * (flat.gather(1, lo) + flat.gather(1, hi))[:, 0]


def _ordered_sum(x, dim):
    """Sum over ``dim`` term by term in index order (XLA's reduction
    order over a short leading axis)."""
    terms = x.unbind(dim)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _segment(values, seg, n, reduce):
    """``reduce`` ("sum", "amin", "amax") of ``values`` by segment id
    ``seg`` (both flat), into ``n`` segments; empty segments hold 0."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg, values, reduce, include_self=False)


def peak_mask_from_plane(plane, validb=None, min_area=4,
                         return_labels=False):
    """Boolean peak mask of detection planes (..., H, W): 4-connected
    footprints above 0 with the reference's ``min_area`` cut (pixel count
    >= min_area and bounding-box area > min_area), and their strict
    8-neighbour local maxima against neighbours of the same footprint
    (ref detect_pybind11.cc:104-195, 241-280).  ``return_labels`` also
    returns the footprint labels."""
    lead = plane.shape[:-2]
    H, W = plane.shape[-2:]
    N = H * W
    p = plane.reshape(-1, H, W)
    B = p.shape[0]
    dev = p.device
    pos = p > 0
    if validb is not None:
        pos = pos & validb.reshape(B, H, W)
    lab = label_components_device(pos)

    # per-footprint pixel count and bounding box over the flat labels,
    # background = segment N of each blend
    seg = (lab.flatten(1) + (N + 1) * torch.arange(B, device=dev)[:, None]
           ).flatten()
    n_seg = B * (N + 1)
    pix = torch.arange(N, device=dev)
    ys = (pix // W).repeat(B)
    xs = (pix % W).repeat(B)
    counts = _segment(pos.flatten().long(), seg, n_seg, "sum")
    height = _segment(ys, seg, n_seg, "amax") \
        - _segment(ys, seg, n_seg, "amin") + 1
    width = _segment(xs, seg, n_seg, "amax") \
        - _segment(xs, seg, n_seg, "amin") + 1
    keep = (counts >= min_area) & (height * width > min_area)

    # a neighbour blocks only if it lies in the same footprint and is >=
    blocked = torch.zeros_like(pos)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nl = _shift_fill(lab, dy, dx, -1)
            nv = _shift_fill(p, dy, dx, 0.0)
            blocked |= (nl == lab) & (nv >= p)
    mask = pos & ~blocked & keep[seg].reshape(B, H, W)
    mask = mask.reshape(*lead, H, W)
    return (mask, lab.reshape(*lead, H, W)) if return_labels else mask


def _cull_min_separation(ys, xs, labs, valid, min_separation):
    """Brightness-greedy min-separation culling of candidate peaks (B, M),
    already brightest first: a peak survives unless a kept brighter peak
    of the same footprint lies within ``min_separation`` (ref
    detect_pybind11.cc:104-195 culls within a footprint only)."""
    M = ys.shape[1]
    min_sep2 = float(min_separation) ** 2
    kept = torch.zeros_like(valid)
    for k in range(M):
        d2 = ((ys - ys[:, k:k + 1]) ** 2
              + (xs - xs[:, k:k + 1]) ** 2).to(torch.float32)
        conflict = (kept & (labs == labs[:, k:k + 1])
                    & (d2 < min_sep2)).any(dim=1)
        kept[:, k] = valid[:, k] & ~conflict
    return kept


def _brightest(vals, k):
    """The ``k`` largest of each row, ties in ascending index (the order
    of ``lax.top_k``; ``torch.topk`` promises none on CUDA)."""
    v, i = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def detect_peaks_device(images, variance, scene_valid=None, *, max_peaks,
                        scales=3, min_area=4, peak_scale=1,
                        min_separation=0):
    """Batched peak catalogs from raw pixel stacks, on the stacks' device
    (scarlet_tpu/parallel/detection.py:188-271).

    images, variance: (B, C, H, W) tensors, non-finite pixels already
    sanitized (``stream_setup`` does it first); scene_valid: optional
    (B, H, W) mask of real pixels for zero-padded crops.  ``max_peaks``
    catalog rows per blend; ``scales`` starlet scales; ``peak_scale`` the
    masked wavelet plane that is segmented; ``min_separation > 0``
    enables the reference's per-footprint culling over a pool of
    4*max_peaks+16 candidates.

    Returns centers (B, max_peaks, 2) int32 (y, x), brightest first;
    active (B, max_peaks) bool (False rows are padding); n_found (B,)
    int32, the peaks before the cut to ``max_peaks``.
    """
    detect_peaks_device.calls += 1
    images = torch.as_tensor(images)
    variance = torch.as_tensor(variance, device=images.device)
    B, C, H, W = images.shape
    dtype = images.dtype
    if scene_valid is None:
        sv = torch.ones((B, H, W), dtype=dtype, device=images.device)
    else:
        sv = torch.as_tensor(scene_valid, device=images.device).to(dtype)
    validb = sv > 0.5
    detect_sum = torch.where(validb, _ordered_sum(images, 1), 0.0)
    sigma = _masked_median_sigma(variance, validb)
    coeffs = wavelet_ops.starlet_transform(detect_sum, scales=scales)
    M = wavelet_ops.multiresolution_support(coeffs, sigma, K=3, epsilon=1e-1,
                                            max_iter=20, valid=sv)
    plane = M[:, peak_scale].to(dtype) * coeffs[:, peak_scale]
    is_peak, lab = peak_mask_from_plane(plane, validb, min_area=min_area,
                                        return_labels=True)
    vals = torch.where(is_peak, plane, float("-inf")).flatten(1)

    if min_separation > 0:
        pool = min(4 * max_peaks + 16, H * W)
        v, i = _brightest(vals, pool)
        kept = _cull_min_separation(i // W, i % W, lab.flatten(1).gather(1, i),
                                    v > 0, min_separation)
        # survivors first, brightness order kept (stable)
        order = torch.sort((~kept).to(torch.int8), dim=1,
                           stable=True).indices[:, :max_peaks]
        active = kept.gather(1, order)
        i = i.gather(1, order)
        n_found = kept.sum(dim=1, dtype=torch.int32)
    else:
        v, i = _brightest(vals, max_peaks)
        active = v > 0
        n_found = is_peak.flatten(1).sum(dim=1, dtype=torch.int32)
    centers = torch.stack([i // W, i % W], dim=-1).to(torch.int32)
    return centers, active, n_found


label_components_device.host_syncs = 0
detect_peaks_device.calls = 0
