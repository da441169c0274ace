"""Special functions: the modified Bessel function of the second kind.

``kv`` (K_nu(x) of real order, for x > 0) is needed by the Spergel (2010)
galaxy profile.  Port of ``scarlet_tpu/ops/special.py``: computed on the
tensor's device from the integral representation

    K_nu(x) = \\int_0^inf exp(-x cosh t) cosh(nu t) dt        (x > 0)

with 256-node Gauss-Legendre quadrature after the substitution
``t = s / (1 - s)`` mapping [0, inf) -> [0, 1).

Differentiation: d/dx K_nu(x) = -(K_{nu-1}(x) + K_{nu+1}(x)) / 2, as a
``torch.autograd.Function``; the derivative with respect to ``nu`` is
zero, as in the reference's autograd registration (defvjp(kv, None, ...)).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["kv"]

_N_NODES = 256
_nodes, _weights = np.polynomial.legendre.leggauss(_N_NODES)
# map [-1, 1] -> [0, 1), then t = s/(1-s) with dt = ds / (1-s)^2
_s = 0.5 * (_nodes + 1.0)
_T = _s / (1.0 - _s)
_WJ = 0.5 * _weights / (1.0 - _s) ** 2
# cosh clipped to 1e300: near s=1 it overflows to inf and exp(-x*inf)
# would meet inf*0; the clipped tail still underflows exp to exactly 0
with np.errstate(over="ignore"):
    _COSH_T = np.minimum(np.cosh(_T), 1e300)

# the node tables per device and dtype
_TABLES = {}


def _tables(like):
    key = (like.device, like.dtype)
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.as_tensor(a, dtype=like.dtype,
                                             device=like.device)
                             for a in (_T, _WJ, _COSH_T))
    return _TABLES[key]


def _kv_primal(nu, x):
    """Quadrature of K_nu(x); broadcasts over ``x`` of any shape."""
    T, WJ, COSH = _tables(x)
    xf = x.reshape(-1, 1)
    expo = -xf * COSH[None, :]
    integrand = 0.5 * (torch.exp(expo + nu * T[None, :])
                       + torch.exp(expo - nu * T[None, :]))
    return torch.sum(integrand * WJ[None, :], dim=-1).reshape(x.shape)


class _KV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nu, x):
        ctx.save_for_backward(nu, x)
        return _kv_primal(nu, x)

    @staticmethod
    def backward(ctx, grad):
        nu, x = ctx.saved_tensors
        dkdx = -(_kv_primal(nu - 1, x) + _kv_primal(nu + 1, x)) / 2.0
        return None, grad * dkdx


def kv(nu, x):
    """Modified Bessel function of the second kind K_nu(x), x > 0; ``nu``
    a number or a tensor (no gradient flows to it)."""
    x = torch.as_tensor(x)
    nu = torch.as_tensor(nu, dtype=x.dtype, device=x.device)
    return _KV.apply(nu, x)
