"""Host-side detection helpers of the wavelet initialization: the bounds
of a monotonic mask as a box, and the significance-masked starlet
coefficients of the band sum.  Port of the two functions of
``scarlet_tpu/detect.py`` that the lite wavelet recipe reads (ref
detect.py:15-26, 420-440)."""
from __future__ import annotations

import numpy as np
import torch

from .bbox import Box
from .ops.wavelet import get_multiresolution_support, starlet_transform

__all__ = ["bounds_to_bbox", "get_detect_wavelets"]


def bounds_to_bbox(bounds):
    """(bottom, top, left, right), inclusive -> Box.  Ref: detect.py:15-26."""
    return Box(
        (int(bounds[1]) + 1 - int(bounds[0]),
         int(bounds[3]) + 1 - int(bounds[2])),
        origin=(int(bounds[0]), int(bounds[2])),
    )


def get_detect_wavelets(images, variance, scales=3):
    """Significance-masked starlet coefficients of the band sum:
    (scales + 1, H, W) float64 (the int mask times the float32
    coefficients, as numpy promotes them).  Ref: detect.py:420-440."""
    sigma = np.median(np.sqrt(variance))
    detect = np.sum(np.asarray(images), axis=0)
    _coeffs = starlet_transform(torch.from_numpy(
        np.ascontiguousarray(detect)), scales=scales).numpy()
    M = get_multiresolution_support(detect, _coeffs, sigma, K=3,
                                    epsilon=1e-1, max_iter=20)
    return M * _coeffs
