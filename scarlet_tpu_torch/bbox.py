"""Static bounding-box geometry.

Boxes describe where a small (source-sized) array lives inside the larger
scene/model coordinate system.  All box arithmetic happens on the host with
plain Python ints; the arrays they index are numpy arrays or CPU tensors.

Behavioral reference: scarlet/bbox.py:4-301 (Box, overlapped_slices).
"""
from __future__ import annotations

import numpy as np

__all__ = ["Box", "overlapped_slices"]


class Box:
    """N-dimensional bounding box: a ``shape`` anchored at ``origin``.

    Conventions: 2D boxes are (Height, Width); 3D boxes are
    (Channels, Height, Width).  Reference: scarlet/bbox.py:4-30.
    """

    def __init__(self, shape, origin=None):
        self.shape = tuple(int(s) for s in shape)
        if origin is None:
            origin = (0,) * len(self.shape)
        if len(origin) != len(self.shape):
            raise ValueError(f"shape {shape} and origin {origin} mismatch")
        self.origin = tuple(int(o) for o in origin)

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_bounds(*bounds):
        """Box from per-dimension (min, max) pairs. Ref: bbox.py:33-48."""
        shape = [max(0, cmax - cmin) for cmin, cmax in bounds]
        origin = [cmin for cmin, _ in bounds]
        return Box(shape, origin=origin)

    @staticmethod
    def from_data(x, min_value=0):
        """Smallest box holding all entries of ``x`` above ``min_value``.

        Ref: bbox.py:50-74.
        """
        x = np.asarray(x)
        sel = x > min_value
        if sel.any():
            nonzero = np.where(sel)
            bounds = [(int(idx.min()), int(idx.max()) + 1) for idx in nonzero]
        else:
            bounds = [(0, 0)] * x.ndim
        return Box.from_bounds(*bounds)

    # -- queries ----------------------------------------------------------
    @property
    def D(self):
        return len(self.shape)

    @property
    def start(self):
        return self.origin

    @property
    def stop(self):
        return tuple(o + s for o, s in zip(self.origin, self.shape))

    @property
    def center(self):
        return tuple(o + s / 2 for o, s in zip(self.origin, self.shape))

    @property
    def bounds(self):
        return tuple((o, o + s) for o, s in zip(self.origin, self.shape))

    @property
    def slices(self):
        return tuple(slice(o, o + s) for o, s in zip(self.origin, self.shape))

    def contains(self, p):
        if len(p) != self.D:
            raise ValueError(f"Dimension mismatch in {p} and {self.D}")
        return all(
            self.origin[d] <= p[d] < self.origin[d] + self.shape[d]
            for d in range(self.D)
        )

    # -- data movement (host-side numpy arrays) --------------------
    def extract_from(self, image, sub=None):
        """Copy the part of ``image`` covered by this box into ``sub``.

        Ref: bbox.py:87-108.  Host-side (numpy arrays).
        """
        imbox = Box(image.shape)
        if sub is None:
            sub = np.zeros(self.shape, dtype=image.dtype)
        im_slices, sub_slices = overlapped_slices(imbox, self)
        sub[sub_slices] = image[im_slices]
        return sub

    def insert_into(self, image, sub):
        """Inverse of :meth:`extract_from`. Ref: bbox.py:110-130."""
        imbox = Box(image.shape)
        im_slices, sub_slices = overlapped_slices(imbox, self)
        image[im_slices] = sub[sub_slices]
        return image

    # -- algebra ----------------------------------------------------------
    def grow(self, radius):
        if not hasattr(radius, "__iter__"):
            radius = [radius] * self.D
        origin = tuple(self.origin[d] - radius[d] for d in range(self.D))
        shape = tuple(self.shape[d] + 2 * radius[d] for d in range(self.D))
        return Box(shape, origin=origin)

    def __or__(self, other):
        """Union: smallest box containing both. Ref: bbox.py:177-197."""
        if other.D != self.D:
            raise ValueError(f"Dimension mismatch: {other} and {self}")
        bounds = [
            (min(self.start[d], other.start[d]), max(self.stop[d], other.stop[d]))
            for d in range(self.D)
        ]
        return Box.from_bounds(*bounds)

    def __and__(self, other):
        """Intersection (empty box if disjoint). Ref: bbox.py:199-224."""
        if other.D != self.D:
            raise ValueError(f"Dimension mismatch: {other} and {self}")
        bounds = [
            (max(self.start[d], other.start[d]), min(self.stop[d], other.stop[d]))
            for d in range(self.D)
        ]
        return Box.from_bounds(*bounds)

    def __getitem__(self, i):
        s_ = self.shape[i]
        o_ = self.origin[i]
        if not hasattr(s_, "__iter__"):
            s_ = (s_,)
            o_ = (o_,)
        return Box(s_, origin=o_)

    def __iadd__(self, offset):
        if not hasattr(offset, "__iter__"):
            offset = (offset,) * self.D
        self.origin = tuple(a + o for a, o in zip(self.origin, offset))
        return self

    def __add__(self, offset):
        return self.copy().__iadd__(offset)

    def __isub__(self, offset):
        if not hasattr(offset, "__iter__"):
            offset = (offset,) * self.D
        self.origin = tuple(a - o for a, o in zip(self.origin, offset))
        return self

    def __sub__(self, offset):
        return self.copy().__isub__(offset)

    def __imatmul__(self, bbox):
        """Outer product: e.g. 1D channel box @ 2D spatial box -> 3D box.

        Ref: bbox.py:256-262.
        """
        bounds = self.bounds + bbox.bounds
        return Box.from_bounds(*bounds)

    def __matmul__(self, bbox):
        return self.copy().__imatmul__(bbox)

    def __copy__(self):
        return Box(self.shape, origin=self.origin)

    def copy(self):
        return self.__copy__()

    def __eq__(self, other):
        return self.shape == other.shape and self.origin == other.origin

    def __hash__(self):
        return hash((self.shape, self.origin))

    def __repr__(self):
        return f"<Box shape={self.shape}, origin={self.origin}>"


def overlapped_slices(bbox1, bbox2):
    """Paired slices into arrays bounded by ``bbox1``/``bbox2`` covering
    their overlap.  Ref: bbox.py:279-301.
    """
    overlap = bbox1 & bbox2
    _bbox1 = overlap - bbox1.origin
    _bbox2 = overlap - bbox2.origin
    return (_bbox1.slices, _bbox2.slices)
