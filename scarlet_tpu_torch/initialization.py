"""Box sizing helpers of the initialization (host-side numpy).

Port of the subset of ``scarlet_tpu/initialization.py`` that the lite
path uses.  Behavioral reference: scarlet/initialization.py.
"""
from __future__ import annotations

import numpy as np

from .bbox import Box

__all__ = ["get_minimal_boxsize", "trim_morphology"]


def get_minimal_boxsize(size, min_size=21, increment=10):
    """Bucket a size into {21, 31, 41, ...}.
    Ref: scarlet/initialization.py:173-177."""
    steps = int(np.ceil(max(size - min_size, 0) / increment))
    return min_size + increment * steps


def trim_morphology(center_index, morph, bg_thresh=0, boxsize=None):
    """Zero sub-threshold pixels and cut a centered odd box around the
    remaining flux.  Ref: scarlet/initialization.py:180-210."""
    morph = np.where(np.asarray(morph) > bg_thresh, morph, 0)

    if boxsize is None:
        # smallest bucketed odd box, centered on the source, covering every
        # surviving pixel: twice the largest center-to-edge reach
        flux_box = Box.from_data(morph, min_value=0)
        cy, cx = center_index
        if flux_box.contains(center_index):
            reach = max(cy - flux_box.start[-2], flux_box.stop[-2] - cy,
                        cx - flux_box.start[-1], flux_box.stop[-1] - cx)
        else:
            reach = 0
        boxsize = get_minimal_boxsize(2 * reach)

    half = boxsize // 2
    bbox = Box.from_bounds(
        (center_index[0] - half, center_index[0] + half + 1),
        (center_index[1] - half, center_index[1] + half + 1))
    return bbox.extract_from(morph), bbox
