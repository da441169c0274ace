"""The yardstick's arithmetic: the H100's published peaks, and the least
bytes and float32 operations that the inputs of a call need, per layer.

Every count is of what the inputs need, not of what the batching
launched: a blend counts its own iterations and its own active
components (``Work``), a component its box's pixels inside the scene
where a kernel reads it there.  Each function says which bound it gives.
Numpy only; nothing here imports the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bytes per second, and float32
# operations per second outside the tensor cores, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4                   # bytes of a float32
TAPS_PER_PIXEL = 4        # nonzero taps a pixel of the "angle" table has
CANDIDATES = 9            # centre candidates of the fit's tables (r = 1)


@dataclass
class Work:
    """What one call's blends needed, per blend (numpy arrays of length
    B): the fit iterations it ran, its active components, the in-scene
    pixels of those components' boxes summed over them, and its active
    catalog rows (the init's projection)."""
    iterations: np.ndarray
    components: np.ndarray
    inscene_pixels: np.ndarray
    catalog_rows: np.ndarray

    def __add__(self, other):
        return Work(*(np.concatenate([a, b]) for a, b in
                      zip(self.astuple(), other.astuple())))

    def astuple(self):
        return (self.iterations, self.components, self.inscene_pixels,
                self.catalog_rows)


def inscene_pixels(origins, box, scene_hw):
    """Pixels of each (S x S) box at ``origins`` (..., 2) inside an
    (H, W) scene."""
    H, W = scene_hw
    oy, ox = np.asarray(origins)[..., 0], np.asarray(origins)[..., 1]
    rows = np.clip(np.minimum(oy + box, H) - np.maximum(oy, 0), 0, None)
    cols = np.clip(np.minimum(ox + box, W) - np.maximum(ox, 0), 0, None)
    return rows * cols


def bound_s(nbytes, nops=0.0):
    """The least seconds the card could take: the larger of the bytes over
    its HBM rate and the operations over its float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


def taps_bytes(box):
    """One candidate's compact monotonicity taps (the weights and one code
    per pixel, and its centre index), as K1 reads them."""
    return box * box * (TAPS_PER_PIXEL * F32 + 4) + 4


def k1_bytes(work, box, launches):
    """K1 (``mono.cu``), bytes bound only: each active morphology read and
    written once per fit iteration, each active catalog row's seed once
    in the init's projection, and the fit tables' taps once per launch.
    K1's passes depend on the data and are not reported, so no
    operations bound is given."""
    morph = box * box * F32
    fit = float(np.sum(work.iterations * work.components)) * 2 * morph
    init = float(np.sum(work.catalog_rows)) * 2 * morph
    return fit + init + launches * CANDIDATES * taps_bytes(box)


def k3_bytes(work, scene):
    """K3 (``scene.cu``), bytes bound: per fit iteration of a blend, its
    (C, H, W) scene written once, and each active component's in-scene
    morphology pixels and its SED read once."""
    C, H, W = scene
    per_iter = C * H * W * F32 + (work.inscene_pixels + work.components * C
                                  ) * F32
    return float(np.sum(work.iterations * per_iter))


def k4_bytes(work, scene, box):
    """K4 (``grad.cu``), bytes bound: per fit iteration of a blend, its
    (C, H, W) gradient read once; per active component its in-scene
    morphology pixels and SED read, its (box x box) morphology gradient
    and its SED gradient written once."""
    C, H, W = scene
    per_iter = C * H * W * F32 + (work.inscene_pixels
                                  + work.components * (box * box + 2 * C)
                                  ) * F32
    return float(np.sum(work.iterations * per_iter))


def rfft2_ops(shape):
    """Float32 operations of one real 2-D FFT of ``shape`` (either way):
    2.5 N log2 N for N real points."""
    n = int(np.prod(shape))
    return 2.5 * n * math.log2(n)


def fit_work(work, scene, box, fft_shape):
    """(bytes, operations) that the fit iterations of a call need at
    least.  Bytes: per iteration of a blend its images and weights read
    once, and each active component's SED and morphology with their two
    Adam moments read and written once.  Operations: the FFTs of the two
    convolutions (each band forward and back, and the spectral
    product)."""
    C, H, W = scene
    its = work.iterations.astype(np.float64)
    params = (box * box + C) * F32 * 3 * 2
    nbytes = float(np.sum(its * (2 * C * H * W * F32
                                 + work.components * params)))
    fh, fw = fft_shape
    spectral = 6 * fh * (fw // 2 + 1)
    per_iter = 2 * C * (2 * rfft2_ops(fft_shape) + spectral)
    return nbytes, float(np.sum(its)) * per_iter


def share_pct(bound_seconds, seconds):
    """A time's share of its bound, in percent; None where nothing ran."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound_seconds / seconds
