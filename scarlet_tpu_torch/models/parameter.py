"""Optimization parameters of the model tree.  Port of
``scarlet_tpu/models/parameter.py``: a :class:`Parameter` holds a tensor
and its metadata (name, prior, constraint, step rule, fixed flag), and
the adaprox moments ``m``, ``v``, ``vhat`` between fits so that warm
restarts work as in the reference (scarlet/blend.py:152-163).

A value made from numpy keeps its dtype; :meth:`Parameter.to` moves a
parameter to a device, in float32 on a CUDA card (where the kernels take
float32) and in a given dtype on the CPU (a fit uses its observations').
:meth:`Parameter.host` gives a numpy copy of the value or a moment, kept
until the tensor changes, so that a fit can fetch every parameter in one
transfer and host code reads them without another.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Parameter", "prepare_param", "relative_step", "place"]

_FIELDS = ("value", "std", "m", "v", "vhat")


def _tensor(x):
    """A tensor of ``x``: a tensor as it is, anything else through numpy
    (a copy, in numpy's dtype: Python floats become float64)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def place(x, device, dtype=None):
    """``x`` as a tensor on ``device``; a floating value becomes float32 on
    a CUDA device (the kernels' precision), else ``dtype`` if given, else
    keeps its own."""
    t = _tensor(x)
    device = torch.device(device)
    if t.is_floating_point():
        if device.type == "cuda":
            dtype = torch.float32
        elif dtype is None:
            dtype = t.dtype
    else:
        dtype = t.dtype
    return t.to(device=device, dtype=dtype)


class Parameter:
    """A named, optionally constrained optimization parameter.

    array: the values (array-like or tensor); name: str; prior: a
    :class:`~.prior.Prior` or None; constraint: a prox ``f(X, step)`` or
    None; step: a float or ``step(X, it)``; std: the posterior error
    estimate, set after fitting; m, v, vhat: adaprox moments for warm
    restarts; fixed: exclude from optimization.
    Ref: scarlet_tpu/models/parameter.py:18-118.
    """

    def __init__(self, array, name="unnamed", prior=None, constraint=None,
                 step=0, std=None, m=None, v=None, vhat=None, fixed=False):
        self.value = _tensor(array)
        self.name = name
        self.prior = prior
        self.constraint = constraint
        self.step = step
        self.std = std
        self.m = m
        self.v = v
        self.vhat = vhat
        self.fixed = fixed
        self._host = {}

    # -- array-like conveniences -----------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def device(self):
        return self.value.device

    def __len__(self):
        return len(self.value)

    def __getitem__(self, i):
        return self.value[i]

    def __array__(self, dtype=None, copy=None):
        arr = self.host()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return f"Parameter('{self.name}', shape={self.shape}, fixed={self.fixed})"

    @property
    def _data(self):
        return self.value

    @property
    def is_finite(self):
        return bool(np.all(np.isfinite(self.host())))

    # -- state management -------------------------------------------------
    def set(self, value):
        """Replace the values (the shape may change on a box resize); the
        new value stays on the parameter's device."""
        self.value = place(value, self.value.device) \
            if self.value.device.type == "cuda" else _tensor(value)
        return self

    def step_size(self, it=0):
        """Evaluate the step rule at the current value and iteration."""
        if callable(self.step):
            return self.step(self.value, it)
        return self.step

    def to(self, device, dtype=None):
        """Move the value and the moments to ``device`` (:func:`place`)."""
        for key in ("value", "m", "v", "vhat"):
            x = getattr(self, key)
            if x is not None:
                setattr(self, key, place(x, device, dtype))
        return self

    def host(self, field="value"):
        """A numpy copy of ``field`` (value, std, m, v or vhat), read from
        the device once per tensor."""
        x = getattr(self, field)
        if x is None or not isinstance(x, torch.Tensor):
            return None if x is None else np.asarray(x)
        hit = self._host.get(field)
        if hit is not None and hit[0] is x:
            return hit[1]
        arr = x.detach().cpu().numpy()
        self._host[field] = (x, arr)
        return arr

    def set_host(self, field, array):
        """Record ``array`` as the host copy of ``field``'s tensor (read
        by the caller in a bulk transfer)."""
        self._host[field] = (getattr(self, field), array)

    # -- pickling ----------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_host", None)
        for key in _FIELDS:
            if isinstance(state[key], torch.Tensor):
                state[key] = state[key].detach().cpu().numpy()
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.value = _tensor(self.value)
        self._host = {}


def prepare_param(X, name, fixed=True, step=None):
    """Wrap a scalar or array into a (fixed) float64 Parameter.
    Ref: parameter.py:116-123."""
    if isinstance(X, Parameter):
        assert X.name == name
        return X
    if np.isscalar(X):
        X = (X,)
    return Parameter(np.array(X, dtype="float"), name=name, fixed=fixed,
                     step=step)


def relative_step(X, it, factor=0.1, minimum=0, axis=None):
    """Step size at ``factor`` times the mean of ``X``, at least
    ``minimum``.  Ref: parameter.py:126-129."""
    X = torch.as_tensor(X)
    mean = X.mean() if axis is None else X.mean(dim=axis)
    if np.isscalar(minimum):
        # a number needs no tensor on the device (and no copy there)
        return torch.clamp_min(factor * mean, minimum)
    minimum = torch.as_tensor(minimum, dtype=X.dtype, device=X.device)
    return torch.maximum(minimum, factor * mean)
