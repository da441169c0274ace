"""Where the port's entry points put their tensors.

An entry point runs on the CUDA card unless its caller asks for another
device: ``device="cpu"`` runs the plain PyTorch versions of the kernels
on the host.  A tensor argument keeps its own device.  Without a card,
``device=None`` raises; it never carries on on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["default_device"]


def default_device(device=None, like=None):
    """``device`` if given; else the device of ``like`` if it is a tensor;
    else the CUDA card (``RuntimeError`` when there is none)."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
