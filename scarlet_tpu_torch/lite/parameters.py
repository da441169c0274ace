"""Per-parameter optimizer wrappers of the lite API.

Mirror the reference's ``LiteParameter`` family
(scarlet/lite/parameters.py:39-317).  The fit engine
(:mod:`scarlet_tpu_torch.lite.engine`) works on the same state arrays
directly; ``LiteBlend.fit`` keeps the two in sync so warm starts work
either way.  Values are host (CPU) tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..optim import (AdaproxState, FistaState, init_adaprox_state,
                     init_fista_state, adaprox_step, fista_step)
from .utils import to_numpy

__all__ = ["LiteParameter", "FistaParameter", "AdaproxParameter"]


def _grow_array(x, new_shape, dist):
    """Zero-pad ``x`` by ``dist`` on each side (2D trailing axes).
    Ref: lite/parameters.py:11-36."""
    x = to_numpy(x)
    result = np.zeros(new_shape, dtype=x.dtype)
    result[dist:-dist, dist:-dist] = x
    return torch.from_numpy(result)


class _ConstantStep:
    """Picklable constant step rule (a local closure would not pickle)."""

    def __init__(self, value):
        self.value = value

    def __call__(self, x, it):
        return self.value


class LiteParameter:
    """Abstract parameter with its own update rule.
    Ref: lite/parameters.py:39-88."""

    def update(self, it, input_grad, *args):
        raise NotImplementedError

    def grow(self, new_shape, dist):
        raise NotImplementedError

    def shrink(self, dist):
        raise NotImplementedError


class FistaParameter(LiteParameter):
    """Beck & Teboulle 2009 accelerated proximal gradient parameter.
    Ref: lite/parameters.py:91-156."""

    def __init__(self, x, step, grad=None, prox=None, t0=1, z0=None):
        self.x = torch.as_tensor(x)
        self.step = step
        self.grad = grad
        self.prox = prox
        self.state = init_fista_state(self.x, z=z0, t=float(t0))

    @property
    def z(self):
        return self.state.z

    @property
    def t(self):
        return float(self.state.t)

    def update(self, it, input_grad, *args):
        # step scaled by 1/|args[0]|^2 as in the reference (the Lipschitz
        # proxy of the other factor, lite/parameters.py:138)
        step = self.step / (torch.as_tensor(args[0]) ** 2).sum()
        g = self.grad(input_grad, self.x, *args)
        self.x, self.state = fista_step(self.x, g, it, self.state, step,
                                        self.prox)

    def grow(self, new_shape, dist):
        self.x = _grow_array(self.x, new_shape, dist)
        self.state = FistaState(z=_grow_array(self.state.z, new_shape, dist),
                                t=self.state.t)

    def shrink(self, dist):
        s = (slice(dist, -dist), slice(dist, -dist))
        self.x = self.x[s]
        self.state = FistaState(z=self.state.z[s], t=self.state.t)


class AdaproxParameter(LiteParameter):
    """Proximal Adam parameter supporting the six adaptive schemes.
    Ref: lite/parameters.py:179-317."""

    def __init__(self, x, step, grad=None, prox=None, b1=0.9, b2=0.999,
                 eps=1e-8, p=0.25, m0=None, v0=None, vhat0=None,
                 scheme="amsgrad", max_prox_iter=1, prox_e_rel=1e-6):
        self.x = torch.as_tensor(x)
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.p = p
        self.step = step if callable(step) else _ConstantStep(step)
        self.grad = grad
        self.prox = prox
        self.scheme = scheme
        self.max_prox_iter = max_prox_iter
        self.e_rel = prox_e_rel
        self.state = init_adaprox_state(self.x, m=m0, v=v0, vhat=vhat0)

    # reference-compatible moment views
    @property
    def m(self):
        return self.state.m

    @property
    def v(self):
        return self.state.v

    @property
    def vhat(self):
        return self.state.vhat

    def update(self, it, input_grad, *args):
        g = self.grad(input_grad, self.x, *args)
        step = self.step(self.x, it)
        self.x, self.state = adaprox_step(
            self.x, g, it, self.state, step, prox=self.prox,
            scheme=self.scheme, b1=self.b1, b2=self.b2, eps=self.eps,
            p=self.p, max_prox_iter=self.max_prox_iter)

    def grow(self, new_shape, dist):
        self.x = _grow_array(self.x, new_shape, dist)
        self.state = AdaproxState(*(_grow_array(a, new_shape, dist)
                                    for a in self.state))

    def shrink(self, dist):
        s = (slice(dist, -dist), slice(dist, -dist))
        self.x = self.x[s]
        self.state = AdaproxState(*(a[s] for a in self.state))
