"""Parameter priors: log-likelihood terms added to the fit objective.

Port of ``scarlet_tpu/models/prior.py`` (ref: scarlet/prior.py:1-19,
abstract only).  ``grad`` is optional: when omitted it is derived with
torch autograd of ``__call__``.
"""
from __future__ import annotations

import torch

__all__ = ["Prior"]


class Prior:
    """Prior base class: ``__call__(*X)`` returns the log-likelihood."""

    def __call__(self, *X):
        raise NotImplementedError

    def grad(self, *X):
        """Gradient of the prior log-likelihood; autograd fallback."""
        Xs = [x.detach().requires_grad_(True) for x in X]
        with torch.enable_grad():
            out = self(*Xs)
        g = torch.autograd.grad(out, Xs)
        return g[0] if len(X) == 1 else g
