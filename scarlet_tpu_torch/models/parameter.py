"""Parameters of the model tree and their step-size rules.  Port of the
part of ``scarlet_tpu/models/parameter.py`` that the lite path, the
renderers and the PSFs use: a :class:`Parameter` holds a tensor and its
metadata.  Priors and constraints come with the object tree."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Parameter", "prepare_param", "relative_step"]


class Parameter:
    """A named, optionally fixed optimization parameter holding a tensor;
    ``step`` is its step rule (a float or ``step(X, it)``), kept for the
    optimizer of the object tree.  Ref: scarlet_tpu/models/parameter.py:
    18-118."""

    def __init__(self, array, name="unnamed", step=0, fixed=False):
        self.value = torch.as_tensor(array)
        self.name = name
        self.step = step
        self.fixed = fixed

    @property
    def shape(self):
        return tuple(self.value.shape)

    def __len__(self):
        return len(self.value)

    def __repr__(self):
        return f"Parameter('{self.name}', shape={self.shape}, fixed={self.fixed})"

    @property
    def is_finite(self):
        return bool(torch.isfinite(self.value).all())


def prepare_param(X, name, fixed=True, step=None):
    """Wrap a scalar or array into a (fixed) float64 Parameter.
    Ref: parameter.py:116-123."""
    if isinstance(X, Parameter):
        assert X.name == name
        return X
    if np.isscalar(X):
        X = (X,)
    return Parameter(torch.as_tensor(np.array(X, dtype="float")), name=name,
                     fixed=fixed, step=step)


def relative_step(X, it, factor=0.1, minimum=0, axis=None):
    """Step size at ``factor`` times the mean of ``X``, at least
    ``minimum``.  Ref: parameter.py:126-129."""
    X = torch.as_tensor(X)
    mean = X.mean() if axis is None else X.mean(dim=axis)
    minimum = torch.as_tensor(minimum, dtype=X.dtype, device=X.device)
    return torch.maximum(minimum, factor * mean)
