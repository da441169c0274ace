"""Proximal Adam (adaprox) and FISTA on torch tensors.

The adaptive-moment ``phi/psi`` rules {adam, nadam, amsgrad, padam, adamx,
radam} and the proximal sub-iteration of lite ``AdaproxParameter``
(scarlet/lite/parameters.py:159-305; Kingma & Ba 2015; Dozat 2016; Reddi,
Kale & Kumar 2018; Chen & Gu 2018; Phuong & Phong 2019; Liu et al. 2019;
Melchior et al. 2019 "Proximal Adam"), and the accelerated proximal
gradient of lite ``FistaParameter`` (lite/parameters.py:91-156; Beck &
Teboulle 2009).

Every update returns new tensors ``(x', state')``; nothing is updated in
place.  ``it`` is the 0-based iteration: a Python number or a tensor that
broadcasts against ``x`` (one count per blend in a batch).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "AdaproxState",
    "FistaState",
    "init_adaprox_state",
    "init_fista_state",
    "phi_psi",
    "adaprox_step",
    "fista_step",
    "SCHEMES",
]

SCHEMES = ("adam", "nadam", "amsgrad", "padam", "adamx", "radam")


class AdaproxState(NamedTuple):
    m: torch.Tensor      # first moment
    v: torch.Tensor      # second moment
    vhat: torch.Tensor   # running max of the second moment


class FistaState(NamedTuple):
    z: torch.Tensor      # extrapolation point, the shape of x
    t: torch.Tensor      # acceleration scalar, one per parameter


def init_fista_state(x, z=None, t=1.0):
    """The FISTA state of ``x``: ``z = x`` (or ``z``), ``t`` in ``x``'s
    dtype."""
    x = torch.as_tensor(x)
    return FistaState(
        z=x if z is None else torch.as_tensor(z, dtype=x.dtype,
                                              device=x.device),
        t=torch.as_tensor(t, dtype=x.dtype, device=x.device),
    )


def init_adaprox_state(x, m=None, v=None, vhat=None):
    """Zero (or warm-start) moments for ``x``.  ``vhat`` starts at 0, which
    equals the reference's ``-inf`` start since ``vhat = max(vhat, v)``
    and ``v >= 0``."""
    x = torch.as_tensor(x)

    def like(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    zeros = torch.zeros_like(x)
    return AdaproxState(
        m=zeros if m is None else like(m),
        v=zeros if v is None else like(v),
        vhat=zeros if vhat is None else torch.clamp_min(like(vhat), 0.0),
    )


def _t(it, like):
    """``it + 1``: a Python float for a Python ``it`` (bias terms then stay
    scalars), else a float tensor on ``like``'s device."""
    if isinstance(it, torch.Tensor):
        return it.to(device=like.device, dtype=like.dtype) + 1.0
    return float(it) + 1.0


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def phi_psi(scheme, it, g, state, b1=0.9, b2=0.999, eps=1e-8, p=0.25):
    """Numerator/denominator of the update ``x <- x - step * phi / psi``.
    Returns ``(phi, psi, new_state)``."""
    assert scheme in SCHEMES, f"unknown scheme {scheme}"
    m = (1 - b1) * g + b1 * state.m
    v = (1 - b2) * (g * g) + b2 * state.v

    if scheme == "amsgrad":
        # Reddi, Kale & Kumar 2018: running max of v, no bias correction
        vhat = torch.maximum(state.vhat, v)
        return m, torch.sqrt(vhat) + eps, AdaproxState(m=m, v=v, vhat=vhat)
    if scheme == "padam":
        # Chen & Gu 2018: partially adaptive exponent p
        vhat = torch.maximum(state.vhat, v)
        return m, vhat ** p + eps, AdaproxState(m=m, v=v, vhat=vhat)

    t = _t(it, g)
    bias1 = 1 - b1 ** t
    bias2 = 1 - b2 ** t
    if scheme == "adam":
        phi = m / bias1
        psi = torch.sqrt(v / bias2) + eps
        vhat = state.vhat
    elif scheme == "nadam":
        # Dozat 2016: Nesterov momentum folded into the bias correction
        phi = (b1 * m + (1 - b1) * g) / bias1
        psi = torch.sqrt(v / bias2) + eps
        vhat = state.vhat
    elif scheme == "adamx":
        # Phuong & Phong 2019: decay the running max by the momentum ratio;
        # the guard keeps it == 0 finite ((1 - b1^0)^2 == 0)
        if isinstance(t, torch.Tensor):
            denom = torch.clamp_min((1 - b1 ** (t - 1)) ** 2, eps)
        else:
            denom = max((1 - b1 ** (t - 1)) ** 2, eps)
        factor = _where(t > 1, (1 - b1 ** t) ** 2 / denom, 1.0)
        vhat = torch.maximum(factor * state.vhat, v)
        phi = m
        psi = torch.sqrt(vhat) + eps
    else:  # radam
        # Liu et al. 2019: variance rectification
        rho_inf = 2.0 / (1 - b2) - 1
        rho = rho_inf - 2 * t * (b2 ** t) / bias2
        mhat = m / bias1
        num = (rho - 4) * (rho - 2) * rho_inf
        den = (rho_inf - 4) * (rho_inf - 2) * rho
        if isinstance(t, torch.Tensor):
            r = torch.sqrt(torch.clamp_min(num / torch.clamp_min(den, eps),
                                           0.0))
        else:
            r = max(num / max(den, eps), 0.0) ** 0.5
        use_adaptive = rho > 4
        phi = _where(use_adaptive, r * mhat, mhat)
        psi = _where(use_adaptive, torch.sqrt(v / bias2) + eps,
                     torch.ones_like(v))
        vhat = state.vhat
    return phi, psi, AdaproxState(m=m, v=v, vhat=vhat)


def adaprox_step(x, g, it, state, step, prox=None, scheme="amsgrad",
                 b1=0.9, b2=0.999, eps=1e-8, p=0.25, max_prox_iter=1,
                 active=None, param_dims=None):
    """One proximal-Adam parameter update (lite/parameters.py:274-305):
    moment update, ``x -= step*phi/psi`` (damped 10x at ``it == 0``), then
    PGM sub-iterations of ``prox`` with step ``gamma = step / max(psi)``.

    ``param_dims``: the trailing dims of one parameter in a stacked batch
    (``max(psi)`` is taken per parameter over them; None = all dims).
    ``active`` (bool, broadcastable to ``x``) freezes x and the moments
    where False.
    """
    phi, psi, new_state = phi_psi(scheme, it, g, state, b1, b2, eps, p)

    it_t = torch.as_tensor(it, device=x.device)
    # 0.1 in x's precision (a 0-dim CPU operand: no copy to the device)
    damp = torch.where(it_t > 0, 1.0, torch.tensor(0.1, dtype=x.dtype))
    x_new = x - damp * step * phi / psi

    if prox is not None:
        if param_dims is None:
            psi_max = psi.max()
        else:
            psi_max = psi.amax(dim=param_dims, keepdim=True)
        gamma = step / psi_max
        if max_prox_iter <= 1:
            x_new = prox(x_new, gamma)
        else:
            # (gamma / step) * psi, the left operand of each sub-step's
            # product, evaluated once: the same values in fewer launches
            pull = gamma / step * psi
            z = x_new
            for _ in range(max_prox_iter):
                z = prox(z - pull * (z - x_new), gamma)
            x_new = z

    if active is not None:
        x_new = torch.where(active, x_new, x)
        new_state = AdaproxState(*(torch.where(active, new, old)
                                   for new, old in zip(new_state, state)))
    return x_new, new_state


def _per_param(a, x):
    """``a`` of one value per parameter, with trailing unit dims so that
    it broadcasts against the stacked parameters ``x``."""
    return a.reshape(a.shape + (1,) * (x.ndim - a.ndim))


def fista_step(x, g, it, state, step, prox=None, active=None):
    """One FISTA (Beck & Teboulle 2009) accelerated PGM update
    (lite/parameters.py:91-156): ``y = z - step g``, ``x' = prox(y)``,
    ``t' = (1 + sqrt(1 + 4 t^2)) / 2``, ``z' = x + (1 + (t - 1)/t')
    (x' - x)``.

    ``state.t`` holds one value per parameter: the leading dims of a stack
    of parameters ``x`` (a scalar for one).  ``step`` broadcasts against
    ``x``.  ``active`` (bool, the shape of ``state.t``) freezes x, z and t
    where False.  ``it`` is unused (the rule has no bias terms).
    """
    y = state.z - step * g
    x_new = prox(y, step) if prox is not None else y
    t_new = 0.5 * (1 + torch.sqrt(1 + 4 * state.t ** 2))
    omega = 1 + (state.t - 1) / t_new
    z_new = x + _per_param(omega, x) * (x_new - x)

    if active is not None:
        a = _per_param(active, x)
        x_new = torch.where(a, x_new, x)
        z_new = torch.where(a, z_new, state.z)
        t_new = torch.where(active, t_new, state.t)
    return x_new, FistaState(z=z_new, t=t_new)
