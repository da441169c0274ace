"""Checkpoint and resume of the lite engine's fit.  Port of
``scarlet_tpu/checkpoint.py``.

The whole fit state (``BlendState``: seeds, morphologies, origins,
optimizer moments, convergence flags) and, optionally, the fit's
``BlendData`` become numpy arrays through ``engine.map_tree`` and are
pickled with the static ``LiteFitConfig``, so a batch of blends can stop
and resume exactly, on the same or another device.  The object tree
checkpoints by pickling its sources, whose Parameters carry their
values and moments as numpy.

A checkpoint written by the JAX package is not read here: its config
unpickles into ``scarlet_tpu`` classes.
"""
from __future__ import annotations

import pathlib
import pickle

import numpy as np
import torch

from .device import default_device
from .lite.engine import map_tree

__all__ = ["save_fit_state", "load_fit_state"]

VERSION = 1


def _to_host(tree):
    return map_tree(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def _to_device(tree, device):
    return map_tree(lambda x: torch.from_numpy(x).to(device)
                    if isinstance(x, np.ndarray) else x, tree)


def save_fit_state(path, config, state, data=None):
    """Save (config, state[, data]) to ``<path>.ckpt``; returns the path.
    Ref: scarlet_tpu/checkpoint.py:37-49."""
    path = pathlib.Path(path).with_suffix(".ckpt")
    payload = {
        "version": VERSION,
        "config": config,
        "state": _to_host(state),
        "data": _to_host(data) if data is not None else None,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def load_fit_state(path, device=None):
    """Load (config, state, data-or-None) saved by :func:`save_fit_state`,
    with the tensors on ``device`` (default: the CUDA card).  Unpickles
    the file: read only checkpoints this program wrote.
    Ref: scarlet_tpu/checkpoint.py:52-58."""
    device = default_device(device)
    path = pathlib.Path(path).with_suffix(".ckpt")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("version") != VERSION:
        raise ValueError(f"{path}: checkpoint version "
                         f"{payload.get('version')!r}, expected {VERSION}")
    state = _to_device(payload["state"], device)
    data = _to_device(payload["data"], device) \
        if payload["data"] is not None else None
    return payload["config"], state, data
