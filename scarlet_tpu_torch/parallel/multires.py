"""Batched multi-resolution deblending: joint fits over many blends
observed by several instruments at different resolutions and rotations.
Port of ``scarlet_tpu/parallel/multires.py``.

The JAX package ``vmap``s one blend's step inside a ``lax.scan``; here
every step works on the batch axis directly, on the device of the
observations (the CUDA card unless they were made elsewhere):

- the scene is :class:`_AssembleScene`, a ``torch.autograd.Function``
  whose forward is kernel ``scene_assembly`` (K3) and whose backward is
  kernel ``grad_gather`` (K4), masked by the slot flags;
- the renderers (``models.ConvolutionRenderer``,
  ``models.ResolutionRenderer``) map the scene batch into each
  observation with operators precomputed once per instrument pair;
- the gradient of ``loss_b = 0.5 sum_o sum w_o (render_o(scene_b) -
  y_o)^2`` comes from autograd (the blends are independent);
- proximal Adam (``optim.adaprox_step``) takes ``max(psi)`` per blend, as
  under ``vmap``; the morphology prox is the centred weighted-monotonic
  projection, kernel ``monotonic_prox`` (K1) at tol 0;
- the loop runs segments of :data:`CHECK_EVERY` iterations with one host
  read of "all blends converged" each, and fills the loss rows it did
  not run with each frozen blend's loss, which is what the JAX scan
  records there.

Host parts (the SED step floor, ``multires_init``, ``multires_records``,
``log_norm``) are numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import optim
from ..lite.engine import _base_half, _edge_pull, pin_float32
from ..ops import kernels
from .stream import _centered_mono_table, _mono_project

__all__ = ["MultiResFitter", "multires_init", "multires_records",
           "deblend_multires", "assemble_scene", "CHECK_EVERY"]

# iterations between two host reads of "every blend has converged"
CHECK_EVERY = 25


def _np(x):
    """A host numpy array of an array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _AssembleScene(torch.autograd.Function):
    """The model-frame scene of each blend, ``sum_k active_k sed_k (x)
    morph_k`` at the integer box origins (which ``multires_init`` keeps
    inside the frame, so no padding is needed).  Forward: kernel
    ``scene_assembly`` (K3); backward: kernel ``grad_gather`` (K4), its
    adjoint, with an inactive slot's gradient set to 0 as the JAX
    package's ``where(active, ...)`` gives it.  On CPU tensors the two
    run as their plain versions."""

    @staticmethod
    def forward(ctx, seds, morphs, origins, active, scene_shape):
        ctx.save_for_backward(seds, morphs, origins, active)
        return kernels.scene_assembly(seds, morphs, origins, active,
                                      scene_shape, 0)

    @staticmethod
    def backward(ctx, grad):
        seds, morphs, origins, active = ctx.saved_tensors
        # K4 reads rows of unit column stride in place
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        g_sed, g_morph = kernels.grad_gather(grad, seds, morphs, origins, 0)
        g_sed = torch.where(active[..., None], g_sed, 0.0)
        g_morph = torch.where(active[..., None, None], g_morph, 0.0)
        return g_sed, g_morph, None, None, None


def assemble_scene(seds, morphs, origins, active, scene_shape):
    """(B, C, H, W) scenes of seds (B, K, C), morphs (B, K, S, S) at
    origins (B, K, 2) int32 with slot flags active (B, K) bool; autograd
    flows to seds and morphs (:class:`_AssembleScene`).  Ref:
    scarlet_tpu/parallel/multires.py:55-73."""
    return _AssembleScene.apply(seds, morphs, origins, active,
                                tuple(scene_shape))


class MultiResFitter:
    """Batched fitter over a fixed set of matched observations.

    Parameters
    ----------
    observations : matched ``models.Observation`` objects sharing one
        model frame (as built by ``Frame.from_observations``); their
        renderers supply the per-instrument transforms and the shared
        precomputed tensors, on the observations' device, where the
        fitter runs.  The observations' own pixel data is not used:
        batched stacks go to :meth:`fit`.
    box_size : source box S (odd) in model-frame pixels.
    e_rel : the reference's relative-loss stop (blend.py:294-296).
    scheme, morph_step, sed_factor : adaprox knobs mirroring the lite
        parameterization (relative SED steps with a noise floor, constant
        morphology step).
    box_grow, box_grow_step : logical box growth (None: static boxes).
    keep_best : return each blend's best iterate instead of the last.

    Ref: scarlet_tpu/parallel/multires.py:76-375.
    """

    def __init__(self, observations, *, box_size, e_rel=1e-4,
                 scheme="amsgrad", morph_step=1e-2, sed_factor=1e-2,
                 max_prox_iter=1, box_grow=None, box_grow_step=5,
                 keep_best=True):
        self.observations = tuple(observations)
        frame = self.observations[0].model_frame
        self.scene_shape = tuple(frame.shape)
        self.device = self.observations[0].device
        pin_float32(self.device)
        self.dtype = torch.float32
        S = int(box_size)
        if S % 2 == 0:
            raise ValueError(f"box_size must be odd, got {S}")
        self.box_size = S
        self.e_rel = float(e_rel)
        self._transforms = tuple(obs.renderer.get_model()
                                 for obs in self.observations)
        w8, keep, depth = _centered_mono_table(S)
        self._mono = (torch.from_numpy(w8).to(self.device),
                      torch.from_numpy(keep).to(self.device), int(depth))
        self._scheme = str(scheme)
        self._morph_step = float(morph_step)
        self._sed_factor = float(sed_factor)
        self._max_prox_iter = int(max_prox_iter)
        # in-program logical box growth (the reference's edge-pull resize,
        # ref morphology.py:160-207, as in lite.engine): slots start at
        # their init-morph support and grow by box_grow_step inside the
        # fixed physical S whenever the next Adam update pulls flux onto
        # the logical box edge; the slot's morph step halves per growth
        self._box_grow = None if box_grow is None else float(box_grow)
        self._box_grow_step = int(box_grow_step)
        # return the best iterate per blend: adaprox is non-monotone and
        # can drift away from its own optimum late in a hard fit
        self._keep_best = bool(keep_best)
        self.last_box_half_ = None
        self.iterations_run_ = 0

    # ---- per-batch pieces ----
    def _tensor(self, x, dtype=None):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()
        return torch.as_tensor(x, dtype=dtype or self.dtype,
                               device=self.device)

    def _loss(self, seds, morphs, origins, active, datas, weights):
        """(B,) losses ``0.5 sum_o sum w_o (render_o(scene) - y_o)^2``."""
        scene = assemble_scene(seds, morphs, origins, active,
                               self.scene_shape)
        total = None
        for t, y, w in zip(self._transforms, datas, weights):
            r = t(scene)
            term = 0.5 * (w * (r - y) ** 2).sum(dim=(-3, -2, -1))
            total = term if total is None else total + term
        return total

    def _prox_morph(self, x, box_half=None):
        w8, keep, depth = self._mono
        if box_half is not None:
            # confine to the grown centred square (box_grow)
            S = x.shape[-1]
            d = (torch.arange(S, device=x.device) - S // 2).abs()
            h = box_half[..., None, None]
            x = x * ((d[:, None] <= h) & (d[None, :] <= h)).to(x.dtype)
        x = torch.clamp_min(x, 0.0)
        x = _mono_project(x, w8, keep, depth)
        mx = x.amax(dim=(-2, -1), keepdim=True)
        return torch.where(mx > 0, x / torch.clamp_min(mx, 1e-30), x)

    @staticmethod
    def _prox_sed(x, gamma):
        return torch.clamp_min(x, 0.0)

    def _sed_step_min(self, weights):
        """Per model channel, the noise rms of each observation's median
        positive weight (nanmedian over the batch: zero-weight pixels must
        not collapse the floor), scattered through the channel maps.
        Ref: multires.py:304-326."""
        out = np.zeros(self.scene_shape[0], np.float32)
        for obs, w in zip(self.observations, weights):
            w = _np(w)
            with np.errstate(invalid="ignore"):
                med = np.nanmedian(np.where(w > 0, w, np.nan),
                                   axis=(0, -2, -1))
            ok = np.isfinite(med) & (med > 0)
            m = np.where(ok, 1.0 / np.sqrt(np.where(ok, med, 1.0)), 0.0)
            cmap = obs.renderer.channel_map
            if cmap is None:
                out[:] = np.maximum(out, m)
            elif isinstance(cmap, (slice, list)):
                idx = cmap if isinstance(cmap, slice) else np.asarray(cmap)
                out[idx] = np.maximum(out[idx], m)
            else:   # mixing matrix: adjoint scatter
                out += np.asarray(cmap).T @ m
        return out

    def _step(self, it, seds, morphs, s_sed, s_morph, run, origins, active,
              datas, weights, step_min, b_half, s_scale):
        """One adaprox iteration of the whole batch: returns the loss of
        the state before the update and the updated state."""
        grow = self._box_grow is not None
        with torch.enable_grad():
            xs = seds.detach().requires_grad_()
            xm = morphs.detach().requires_grad_()
            loss = self._loss(xs, xm, origins, active, datas, weights)
            g_sed, g_morph = torch.autograd.grad(loss.sum(), (xs, xm))
        loss = loss.detach()
        # lite SED steps: factor x per-component mean, floored at the
        # per-channel noise rms
        step_sed = torch.maximum(
            step_min, self._sed_factor * seds.mean(dim=-1, keepdim=True))
        new_seds, s_sed = optim.adaprox_step(
            seds, g_sed, it, s_sed, step_sed, prox=self._prox_sed,
            scheme=self._scheme, max_prox_iter=self._max_prox_iter,
            active=run[:, None, None], param_dims=(-2, -1))
        if grow:
            mstep = self._morph_step * s_scale[..., None, None]
            box_half = b_half
        else:
            mstep, box_half = self._morph_step, None
        new_morphs, s_morph = optim.adaprox_step(
            morphs, g_morph, it, s_morph, mstep,
            prox=lambda x, g: self._prox_morph(x, box_half),
            scheme=self._scheme, max_prox_iter=self._max_prox_iter,
            active=run[:, None, None, None], param_dims=(-3, -2, -1))
        if grow:
            S = self.box_size
            pull = _edge_pull(new_morphs, s_morph.m, s_morph.v,
                              (self._morph_step * s_scale).to(self.dtype),
                              b_half, (S // 2, S // 2))
            can = (b_half + self._box_grow_step) <= S // 2
            trig = (pull > self._box_grow) & can & run[:, None] & active
            b_half = torch.where(trig, b_half + self._box_grow_step, b_half)
            s_scale = torch.where(trig, s_scale * 0.5, s_scale)
        return loss, new_seds, new_morphs, s_sed, s_morph, b_half, s_scale

    # ---- public API ----
    def fit(self, datas, weights, seds, morphs, origins, active=None, *,
            n_iter=100, min_iter=1, sed_step_min=None):
        """Fit a batch of blends jointly against all observations.

        Parameters
        ----------
        datas, weights : per-observation stacks, one (B, C_o, H_o, W_o)
            array or tensor per observation (in the fitter's order).
        seds : (B, K, C_total) initial spectra over the model frame's
            channels.
        morphs : (B, K, S, S) initial morphologies.
        origins : (B, K, 2) int top-left corners of each box in the model
            frame (in bounds).
        active : (B, K) bool slot mask.
        sed_step_min : (C_total,) SED step floor (default: per-channel
            noise rms from the batch median of the weights).

        Returns (seds, morphs, final_loss, iterations, losses), tensors on
        the fitter's device, with ``losses`` the (n_iter, B) loss history
        (frozen after convergence) where loss = -logL up to the Gaussian
        normalization.  Ref: multires.py:268-348.
        """
        datas = tuple(self._tensor(d) for d in datas)
        weights = tuple(self._tensor(w) for w in weights)
        if (len(datas) != len(self._transforms)
                or len(weights) != len(self._transforms)):
            raise ValueError("one data AND weights stack per observation")
        seds = self._tensor(seds)
        morphs = self._tensor(morphs)
        origins = self._tensor(origins, torch.int32)
        if active is None:
            active = torch.ones(seds.shape[:2], dtype=torch.bool,
                                device=self.device)
        else:
            active = self._tensor(active, torch.bool)
        if sed_step_min is None:
            sed_step_min = self._sed_step_min(weights)
        step_min = self._tensor(sed_step_min)
        B, K = seds.shape[:2]
        S = self.box_size
        grow = self._box_grow is not None
        if grow:
            # initial logical half-size: the init morphology's support
            # extent from the box centre
            box_half = _base_half((morphs > 0).to(self.dtype),
                                  (S // 2, S // 2))
        else:
            box_half = torch.zeros((B, K), dtype=torch.int32,
                                   device=self.device)
        s_scale = torch.ones((B, K), dtype=self.dtype, device=self.device)

        s_sed = optim.init_adaprox_state(seds)
        s_morph = optim.init_adaprox_state(morphs)
        last_loss = torch.full((B,), float("inf"), dtype=self.dtype,
                               device=self.device)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        iters = torch.zeros(B, dtype=torch.int32, device=self.device)
        best = (last_loss, seds, morphs)
        losses = torch.empty((int(n_iter), B), dtype=self.dtype,
                             device=self.device)
        ran = 0
        while ran < n_iter:
            for it in range(ran, min(ran + CHECK_EVERY, int(n_iter))):
                run = ~done
                (loss, new_seds, new_morphs, s_sed, s_morph, box_half,
                 s_scale) = self._step(
                    it, seds, morphs, s_sed, s_morph, run, origins, active,
                    datas, weights, step_min, box_half, s_scale)
                if self._keep_best:
                    # the recorded loss belongs to the state before the
                    # update: it becomes the incumbent where it improves
                    b_loss, b_seds, b_morphs = best
                    better = loss < b_loss
                    best = (torch.where(better, loss, b_loss),
                            torch.where(better[:, None, None], seds, b_seds),
                            torch.where(better[:, None, None, None], morphs,
                                        b_morphs))
                seds, morphs = new_seds, new_morphs
                # the reference's stop: |dL| < e_rel * |L|
                conv = ((loss - last_loss).abs() < self.e_rel * loss.abs()) \
                    & (it >= min_iter)
                iters = iters + run.to(torch.int32)
                last_loss = torch.where(run, loss, last_loss)
                done = done | conv
                losses[it] = loss
                ran = it + 1
            if bool(done.all()):
                break
        self.iterations_run_ = ran

        if self._keep_best or ran < n_iter:
            # the final state's own loss: the JAX scan records it in every
            # row after the last blend froze, and keep_best scores it
            with torch.no_grad():
                final_loss = self._loss(seds, morphs, origins, active, datas,
                                        weights)
            losses[ran:] = final_loss
        if self._keep_best:
            b_loss, b_seds, b_morphs = best
            better = final_loss < b_loss
            seds = torch.where(better[:, None, None], seds, b_seds)
            morphs = torch.where(better[:, None, None, None], morphs,
                                 b_morphs)
            last_loss = torch.minimum(final_loss, b_loss)
        self.last_box_half_ = _np(box_half) if grow else None
        return seds, morphs, last_loss, iters, losses

    def render_batch(self, seds, morphs, origins, active):
        """Batched per-observation renders of the fitted models: a tuple of
        (B, C_o, H_o, W_o) tensors."""
        with torch.no_grad():
            scene = assemble_scene(
                self._tensor(seds), self._tensor(morphs),
                self._tensor(origins, torch.int32),
                self._tensor(active, torch.bool), self.scene_shape)
            return tuple(t(scene) for t in self._transforms)

    def log_norm(self, weights):
        """Per-blend Gaussian normalization constants (summed over
        observations), so ``logL = -loss - log_norm`` matches
        ``Observation.get_log_likelihood`` (ref observation.py:172-186).
        Host numpy."""
        total = 0.0
        for w in weights:
            w = _np(w)
            finite = w > 0
            D = finite.sum(axis=(1, 2, 3))
            # rms = 1/sqrt(w): sum log rms = -0.5 sum log w
            logw = np.where(finite, np.log(np.where(finite, w, 1.0)), 0.0)
            total = total + D / 2 * np.log(2 * np.pi) \
                - 0.5 * logw.sum(axis=(1, 2, 3))
        return total


def multires_records(fitter, seds, morphs, origins, active, loss, iters,
                     weights=None):
    """Per-blend measurement records from a finished :meth:`fit` (host
    numpy): ``flux`` (K, C_total, the exact model integral per channel),
    ``centroid`` (K, 2, intensity-weighted, model-frame pixels, NaN for
    inactive slots), ``moments`` (K, 3, flux-normalized central second
    moments s_yy, s_xx, s_xy), ``iterations`` and ``logL`` (with the
    Gaussian normalization when ``weights`` is given, else the negative
    loss).  Ref: scarlet_tpu/parallel/multires.py:378-424.
    """
    seds, morphs, origins, active, loss, iters = (
        _np(a) for a in (seds, morphs, origins, active, loss, iters))
    B, K, S = morphs.shape[:3]
    yy, xx = np.mgrid[0:S, 0:S].astype(float)
    log_norm = (fitter.log_norm(weights) if weights is not None
                else np.zeros(B))
    records = []
    for b in range(B):
        flux = (seds[b] * morphs[b].sum((-2, -1))[:, None]) \
            * active[b][:, None]
        cen = np.full((K, 2), np.nan)
        mom = np.full((K, 3), np.nan)
        for k in range(K):
            tot = morphs[b, k].sum()
            if active[b, k] and tot > 0:
                cy = (yy * morphs[b, k]).sum() / tot
                cx = (xx * morphs[b, k]).sum() / tot
                cen[k] = (cy + origins[b, k, 0], cx + origins[b, k, 1])
                mom[k] = (
                    (((yy - cy) ** 2) * morphs[b, k]).sum() / tot,
                    (((xx - cx) ** 2) * morphs[b, k]).sum() / tot,
                    ((yy - cy) * (xx - cx) * morphs[b, k]).sum() / tot)
        records.append({
            "flux": flux,
            "centroid": cen,
            "moments": mom,
            "iterations": int(iters[b]),
            "logL": float(-loss[b] - log_norm[b]),
        })
    return records


def multires_init(observations, datas, centers, *, box_size, n_slots,
                  dtype=np.float32):
    """Host initialization for :class:`MultiResFitter` (numpy).

    Compact-source seeding: every catalog position gets the model-frame
    PSF image as its morphology seed (max-normalized) and the per-channel
    pixel value at its position in each observation as its spectrum seed.

    ``datas``: per-observation (B, C_o, H_o, W_o) stacks; ``centers``:
    (B, K, 2) float (y, x) model-frame positions, NaN rows inactive.
    Returns (seds, morphs, origins, active) for ``fit``.
    Ref: scarlet_tpu/parallel/multires.py:427-500.
    """
    frame = observations[0].model_frame
    C_tot, H, W = frame.shape
    B, K = np.asarray(centers).shape[:2]
    S = int(box_size)
    centers = np.asarray(centers, float)
    active = np.isfinite(centers).all(-1)
    if K > int(n_slots):
        raise ValueError(f"centers rows ({K}) exceed n_slots ({n_slots})")
    datas = tuple(_np(d) for d in datas)

    # morphology seed: the model-frame PSF stamp, centred, max-normalized
    psf = _np(frame.psf.get_model()).astype(dtype)[0]
    ph, pw = psf.shape
    morph0 = np.zeros((S, S), dtype)
    oy, ox = (S - ph) // 2, (S - pw) // 2
    sy, sx = max(0, -oy), max(0, -ox)
    ty, tx = max(0, oy), max(0, ox)
    h = min(ph - sy, S - ty)
    w = min(pw - sx, S - tx)
    morph0[ty:ty + h, tx:tx + w] = psf[sy:sy + h, sx:sx + w]
    morph0 /= morph0.max()

    seds = np.zeros((B, K, C_tot), dtype)
    morphs = np.zeros((B, K, S, S), dtype)
    origins = np.zeros((B, K, 2), np.int32)
    for b in range(B):
        for k in range(K):
            if not active[b, k]:
                continue
            cy, cx = centers[b, k]
            origins[b, k] = (
                np.clip(int(round(cy)) - S // 2, 0, H - S),
                np.clip(int(round(cx)) - S // 2, 0, W - S))
            morphs[b, k] = morph0
            for obs, data in zip(observations, datas):
                py, px = np.asarray(
                    frame.convert_pixel_to(obs, pixel=(cy, cx)),
                    float).reshape(-1)[:2]
                iy = int(np.clip(round(py), 0, data.shape[-2] - 1))
                ix = int(np.clip(round(px), 0, data.shape[-1] - 1))
                # peak-pixel spectrum: with max-normalized morphologies
                # the model's peak channel value is the sed
                spec = np.maximum(data[b, :, iy, ix], 1e-12)
                cmap = obs.renderer.channel_map
                if cmap is None:
                    seds[b, k] += spec
                elif isinstance(cmap, (slice, list)):
                    idx = cmap if isinstance(cmap, slice) \
                        else np.asarray(cmap)
                    seds[b, k][idx] += spec
                else:   # mixing matrix: adjoint scatter
                    seds[b, k] += np.asarray(cmap).T @ spec
    return seds, morphs, origins, active


def deblend_multires(observations, datas, weights=None, centers=None, *,
                     box_size, n_slots, detect_obs=0, max_peaks=None,
                     detect_scales=3, n_iter=100, **fitter_kw):
    """One-call batched multi-resolution pipeline: raw per-instrument pixel
    stacks -> per-blend measurement records, on the observations' device.

    With ``centers=None`` the catalogs are detected on the device from
    observation ``detect_obs``'s stack (``detection.detect_peaks_device``;
    pick the highest-resolution instrument) and mapped into model-frame
    coordinates through the shared WCS pair; otherwise ``centers`` is
    (B, K, 2) model-frame positions (NaN rows inactive).  ``weights``
    defaults to ones; detection takes its variance as 1/weights (weight 0
    -> masked).

    Returns (records, seds, morphs, origins, active, losses).
    Ref: scarlet_tpu/parallel/multires.py:503-562.
    """
    observations = tuple(observations)
    datas = tuple(_np(d).astype(np.float32) for d in datas)
    if weights is None:
        weights = tuple(np.ones_like(d) for d in datas)
    else:
        weights = tuple(_np(w).astype(np.float32) for w in weights)
    frame = observations[0].model_frame

    if centers is None:
        from .detection import detect_peaks_device

        obs_d = observations[detect_obs]
        data_d = datas[detect_obs]
        w_d = weights[detect_obs]
        var = np.where(w_d > 0, 1.0 / np.maximum(w_d, 1e-20), 0.0)
        if max_peaks is None:
            max_peaks = int(n_slots)
        dev = obs_d.device
        det_c, det_a, _ = detect_peaks_device(
            torch.as_tensor(data_d, device=dev),
            torch.as_tensor(var.astype(np.float32), device=dev),
            max_peaks=int(max_peaks), scales=int(detect_scales))
        det_c, det_a = _np(det_c).astype(float), _np(det_a)
        B, K = det_a.shape
        centers = np.full((B, K, 2), np.nan)
        for b in range(B):
            if det_a[b].any():
                # detected (y, x) are obs-grid pixels; map them into the
                # model frame through the shared WCS pair
                pix = obs_d.convert_pixel_to(frame, pixel=det_c[b, det_a[b]])
                centers[b, :det_a[b].sum()] = np.atleast_2d(
                    np.asarray(pix, float))

    fitter = MultiResFitter(observations, box_size=box_size, **fitter_kw)
    init = multires_init(observations, datas, centers, box_size=box_size,
                         n_slots=n_slots)
    seds, morphs, loss, iters, losses = fitter.fit(
        datas, weights, *init, n_iter=int(n_iter))
    records = multires_records(fitter, seds, morphs, init[2], init[3],
                               loss, iters, weights=weights)
    return records, seds, morphs, init[2], init[3], losses
