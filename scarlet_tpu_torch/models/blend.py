"""Blend: the blended scene and its fitting engine.  Port of
``scarlet_tpu/models/blend.py``.

The fit runs on the observations' device, in their precision (the model
frame's, float64 or float32) on the CPU and in float32 on a card.

One iteration computes the scene (each source's boxed model added into
the frame by index), the likelihood over all observations, its gradient
over the free parameters by torch autograd (the observations' own
parameters, e.g. a ``psf_shift``, included), and per free parameter the
adaprox update with its prox and ``prox_max_iter`` sub-iterations.
Everything stays on the observations' device: the convergence test
``|dL| < e_rel |L|`` is a device mask that freezes the iterate exactly as
the JAX package's segment does, and the host reads once per segment of
at most 10 iterations (losses, the iteration count, the mask, and every
free parameter with its moments, for the box updates and the finite
check).  Segments never straddle the every-10-iterations ``src.update()``;
a box resize (:class:`UpdateException`) restarts with warm moments at the
new shapes.  Behavioral reference: scarlet/blend.py.
"""
from __future__ import annotations

import logging
from functools import partial

import numpy as np
import torch

from ..bbox import overlapped_slices
from ..optim import AdaproxState, adaprox_step, init_adaprox_state
from .component import CombinedComponent
from .model import UpdateException
from .parameter import place

logger = logging.getLogger("scarlet_tpu_torch.blend")

__all__ = ["Blend"]

_MOMENTS = ("m", "v", "vhat")


def _device_step(step, device, dtype):
    """The step rule with its array arguments (a ``partial``'s keywords,
    e.g. ``relative_step``'s noise floor) on ``device``, so that
    evaluating it copies nothing to the device."""
    if not isinstance(step, partial):
        return step
    kw = {k: place(v, device, dtype)
          if isinstance(v, (np.ndarray, torch.Tensor)) else v
          for k, v in step.keywords.items()}
    return partial(step.func, *step.args, **kw)


def _warm(x, a):
    """A stored moment usable for ``x`` (a warm restart): same shape, else
    None (zeros)."""
    return a if a is not None and tuple(np.shape(a)) == tuple(x.shape) \
        else None


class Blend(CombinedComponent):
    """Sources + observations with a proximal-Adam fit on the
    observations' device.  Ref: scarlet/blend.py:49-308.
    """

    def __init__(self, sources, observations):
        if hasattr(sources, "__iter__"):
            self.sources = sources
        else:
            self.sources = (sources,)
        if hasattr(observations, "__iter__"):
            self.observations = observations
        else:
            self.observations = (observations,)
        super().__init__(self.sources)
        self.loss = []

    @property
    def bbox(self):
        return self.frame.bbox

    @property
    def device(self):
        return self.observations[0].device

    @property
    def dtype(self):
        """The fit's precision: the observations' (the model frame's) on
        the CPU; float32 on a card."""
        return self.observations[0].data.dtype

    def get_model(self, *parameters, frame=None):
        """Add all source models into the scene, each at its box's place
        (plain indexed adds; autograd flows through them).
        Ref: blend.py:200-244."""
        models = self.get_models_of_children(*parameters, frame=None)
        if frame is None:
            frame = self.frame
        if frame == self.frame:
            slices = tuple(
                (src._model_frame_slices, src._model_slices)
                for src in self.sources
            )
        else:
            slices = tuple(
                overlapped_slices(frame.bbox, src.bbox)
                for src in self.sources
            )
        full_model = models[0].new_zeros(frame.shape)
        for model, (fslice, mslice) in zip(models, slices):
            full_model[fslice] += model[mslice]
        return full_model

    @property
    def log_likelihood(self):
        return -np.array(self.loss)

    # -- fitting ----------------------------------------------------------
    def _collect_parameters(self):
        X = list(self.parameters) + [
            p for obs in self.observations for p in obs.parameters
        ]
        free = [k for k, x in enumerate(X) if not x.fixed]
        return X, free

    def _make_update(self, X, free, scheme, b1, b2, eps, p_pow,
                     prox_max_iter):
        """The update of one iteration over the free parameters:
        ``update(free_vals, opt_states, it, data_weights)`` returns the new
        values, the new states and the loss at the incoming values."""
        n_model = len(self.parameters)
        dev = self.device
        steps = [_device_step(x.step, dev, self.dtype) for x in X]
        proxes = [x.constraint for x in X]
        priors = [x.prior for x in X]

        def neg_logL(free_vals, data_weights):
            vals = [x.value for x in X]
            for i, k in enumerate(free):
                vals[k] = free_vals[i]
            model = self.get_model(*vals[:n_model], frame=self.frame)
            total = 0.0
            i = n_model
            for obs, (data, weights) in zip(self.observations, data_weights):
                n_obs = len(obs.parameters)
                model_ = obs.renderer(model, *vals[i:i + n_obs])
                total = total + obs.log_norm + \
                    torch.sum(weights * (model_ - data) ** 2) / 2
                i += n_obs
            return total

        def update(free_vals, opt_states, it, data_weights):
            xs = [v.detach().requires_grad_(True) for v in free_vals]
            with torch.enable_grad():
                loss = neg_logL(xs, data_weights)
                grads = torch.autograd.grad(loss, xs)
            new_vals, new_states = [], []
            for i, k in enumerate(free):
                x = free_vals[i]
                g = grads[i]
                if priors[k] is not None:
                    g = g - priors[k].grad(x)
                s = steps[k]
                s_val = s(x, it) if callable(s) else s
                x_new, st_new = adaprox_step(
                    x, g, it, opt_states[i], s_val, prox=proxes[k],
                    scheme=scheme, b1=b1, b2=b2, eps=eps, p=p_pow,
                    max_prox_iter=prox_max_iter)
                new_vals.append(x_new)
                new_states.append(st_new)
            return new_vals, new_states, loss.detach()

        return update

    @torch.no_grad()
    def _segment(self, update, free_vals, opt_states, it0, data_weights,
                 last_loss, e_rel, min_iter, n):
        """``n`` iterations with the device-side convergence mask: once
        ``|dL| < e_rel |L|`` fires the iterate and the moments freeze (the
        iteration that detects it is applied and recorded, blend.py:180-196).
        Returns the values, states, losses (n,), iterations executed and
        the mask, all on the device; ``last_loss`` is the loss before the
        segment (a float, inf at the start)."""
        dev = self.device
        active = torch.ones((), dtype=torch.bool, device=dev)
        n_done = torch.zeros((), dtype=torch.int64, device=dev)
        last = None
        losses = []
        for _ in range(n):
            cur_it = n_done + it0
            new_vals, new_states, loss = update(free_vals, opt_states,
                                                cur_it, data_weights)
            if last is None:
                last = torch.full((), last_loss, dtype=loss.dtype,
                                  device=dev)
            free_vals = [torch.where(active, nv, v)
                         for nv, v in zip(new_vals, free_vals)]
            opt_states = [AdaproxState(*(torch.where(active, a, b)
                                         for a, b in zip(ns, os)))
                          for ns, os in zip(new_states, opt_states)]
            n_done = n_done + active
            converged = (n_done + it0 > min_iter) & (
                torch.abs(loss - last) < e_rel * torch.abs(loss))
            last = torch.where(active, loss, last)
            active = active & ~converged
            losses.append(loss)
        return free_vals, opt_states, torch.stack(losses), n_done, active

    def fit(self, max_iter=200, e_rel=1e-3, min_iter=1, noise_factor=0,
            segment=10, rng=None, **alg_kwargs):
        """Fit all free parameters on the observations' device.
        Ref: scarlet/blend.py:85-198.

        ``segment`` iterations run between host reads; the device-side
        convergence mask freezes updates the moment |dL| < e_rel |L|
        fires, so the iterate sequence equals per-iteration stepping
        (``segment=1``).  Host work -- the finite check, box-resize
        ``src.update()`` -- happens at segment boundaries, which fall on
        the reference's every-10-iterations update cadence
        (blend.py:283-289).  A per-iteration ``callback`` or
        ``noise_factor`` re-draws force ``segment=1``; the re-draws come
        from ``rng`` (a ``numpy.random.Generator``; default numpy's
        global stream, as the JAX package draws).

        Returns (n_iterations, final logL).
        """
        scheme = alg_kwargs.pop("scheme", "amsgrad")
        prox_max_iter = alg_kwargs.pop("prox_max_iter", 10)
        callback = alg_kwargs.pop("callback", None)
        b1 = alg_kwargs.pop("b1", 0.9)
        b2 = alg_kwargs.pop("b2", 0.999)
        eps = alg_kwargs.pop("eps", 1e-8)
        p_pow = alg_kwargs.pop("p", 0.25)
        if callback is not None or noise_factor > 0:
            segment = 1
        # source updates fire at it % 10 == 0: segments must not straddle
        # those boundaries
        segment = max(1, min(int(segment), 10))
        rng = np.random if rng is None else rng

        it = len(self.loss)
        fixed_weights = (self._data_weights(0, rng) if noise_factor == 0
                         else None)
        while it < max_iter:
            X, free = self._collect_parameters()
            for x in X:
                x.to(self.device, self.dtype)
            update = self._make_update(X, free, scheme, b1, b2, eps, p_pow,
                                       prox_max_iter)
            free_vals = [X[k].value for k in free]
            opt_states = [init_adaprox_state(X[k].value, *(
                _warm(X[k].value, getattr(X[k], f)) for f in _MOMENTS))
                for k in free]

            data_weights = (fixed_weights if fixed_weights is not None
                            else self._data_weights(noise_factor, rng))
            try:
                while it < max_iter:
                    n = min(segment, max_iter - it,
                            (it // 10 + 1) * 10 - it)
                    last = self.loss[-1] if self.loss else float("inf")
                    free_vals, opt_states, losses, n_done, active = \
                        self._segment(update, free_vals, opt_states, it,
                                      data_weights, last, e_rel, min_iter, n)
                    self._sync(X, free, free_vals, opt_states)
                    losses, n_exec, converged = self._fetch(
                        X, free, losses, n_done, active)
                    self.loss.extend(losses[:n_exec].tolist())
                    it += n_exec
                    if noise_factor > 0:
                        data_weights = self._data_weights(noise_factor, rng)
                    self._callback(it, e_rel=e_rel, min_iter=min_iter,
                                   callback=callback, converged=converged)
                break
            except StopIteration:
                break
            except UpdateException:
                # box resize: restart with warm moments at the new shapes
                continue

        # posterior std estimate (blend.py:188-192)
        X, free = self._collect_parameters()
        for k in free:
            v = X[k].host("v")
            if v is not None:
                with np.errstate(divide="ignore"):
                    X[k].std = np.where(
                        v > 0, 1 / np.sqrt(np.where(v > 0, v, 1)), np.inf)
        logger.info(
            f"scarlet_tpu_torch ran for {len(self.loss)} iterations to "
            f"logL = {self.log_likelihood[-1] if self.loss else np.nan}")
        return len(self.loss), (self.log_likelihood[-1] if self.loss
                                else np.nan)

    def _data_weights(self, noise_factor, rng):
        out = []
        for obs in self.observations:
            data = obs.data
            weights = obs.weights
            if noise_factor > 0:
                rms = np.where(np.isfinite(obs.noise_rms), obs.noise_rms, 0.0)
                noise = rng.normal(loc=0, scale=rms)
                data = data + place(noise, data.device, data.dtype)
                weights = weights / (noise_factor + 1)
            out.append((data, weights))
        return tuple(out)

    def _sync(self, X, free, free_vals, opt_states):
        """Write updated values and moments back onto the Parameters."""
        for i, k in enumerate(free):
            X[k].value = free_vals[i]
            X[k].m, X[k].v, X[k].vhat = opt_states[i]

    def _fetch(self, X, free, losses, n_done, active):
        """One device-to-host transfer at the segment's end: the losses,
        the iterations run, the mask and, from a card, every free parameter
        with its moments (kept as their host copies, ``Parameter.host``).
        Returns (losses, iterations run, converged)."""
        fields = [] if self.device.type == "cpu" else \
            [(X[k], f) for k in free for f in ("value",) + _MOMENTS]
        parts = [losses, n_done.reshape(1), active.reshape(1)] + \
            [getattr(p, f).reshape(-1) for p, f in fields]
        flat = torch.cat([t.to(torch.float64) for t in parts]).cpu().numpy()
        n = len(losses)
        off = n + 2
        for p, f in fields:
            t = getattr(p, f)
            p.set_host(f, flat[off:off + t.numel()].reshape(tuple(t.shape))
                       .astype(str(t.dtype).split(".")[-1]))
            off += t.numel()
        return flat[:n], int(flat[n]), not bool(flat[n + 1])

    def _callback(self, it, e_rel=1e-3, min_iter=1, callback=None,
                  converged=None):
        """Finite check + periodic model update + convergence test.
        Ref: scarlet/blend.py:276-302.  The convergence test itself runs
        on the device inside the segment; ``converged`` reports it.
        """
        for src in self.sources:
            src.check_parameters()

        if it > 0 and it % 10 == 0:
            throw = False
            for src in self.sources:
                try:
                    src.update()
                except UpdateException:
                    throw = True
            if throw:
                raise UpdateException

        if converged is None:
            converged = it > min_iter and len(self.loss) >= 2 and \
                abs(self.loss[-1] - self.loss[-2]) < \
                e_rel * np.abs(self.loss[-1])
        if converged:
            raise StopIteration("scarlet_tpu_torch.Blend.fit() converged")

        if callback is not None:
            callback(it=it)

