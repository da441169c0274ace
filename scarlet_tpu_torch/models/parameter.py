"""Step-size rules of parameters.  Port of the part of
``scarlet_tpu/models/parameter.py`` that the lite path uses."""
from __future__ import annotations

import torch

__all__ = ["relative_step"]


def relative_step(X, it, factor=0.1, minimum=0, axis=None):
    """Step size at ``factor`` times the mean of ``X``, at least
    ``minimum``.  Ref: parameter.py:126-129."""
    X = torch.as_tensor(X)
    mean = X.mean() if axis is None else X.mean(dim=axis)
    minimum = torch.as_tensor(minimum, dtype=X.dtype, device=X.device)
    return torch.maximum(minimum, factor * mean)
