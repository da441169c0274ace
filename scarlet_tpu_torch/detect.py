"""Source detection on the host: starlet footprints, peaks and blend
structures.  Port of ``scarlet_tpu/detect.py`` but its matplotlib
drawing helpers: numpy and scipy, as there (detection runs once per
blend, before the fit), with the transforms in torch on the CPU.
Connected components come from ``scipy.ndimage.label`` (4-connected);
peaks are strict 8-neighbour maxima, ordered by a stable sort of their
negated flux, then culled by minimum separation (brighter first).

Behavioral references: scarlet/detect.py and scarlet/detect_pybind11.cc.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from .bbox import Box, overlapped_slices
from .ops.wavelet import get_multiresolution_support, starlet_transform

__all__ = [
    "Peak",
    "Footprint",
    "get_connected_pixels",
    "get_footprints",
    "bounds_to_bbox",
    "box_intersect",
    "footprint_intersect",
    "QuadTreeRegion",
    "SingleScaleStructure",
    "get_wavelets",
    "get_detect_wavelets",
    "get_blend_trees",
    "get_blend_structures",
    "get_peaks",
]


class Peak:
    """A local maximum in a footprint. Ref: detect_pybind11.cc:65-90."""

    __slots__ = ("y", "x", "flux")

    def __init__(self, y, x, flux):
        self.y = int(y)
        self.x = int(x)
        self.flux = float(flux)

    def __repr__(self):
        return f"Peak(y={self.y}, x={self.x}, flux={self.flux:.4g})"


class Footprint:
    """A connected above-threshold region with its peaks.

    Ref: detect_pybind11.cc:199-220.
    """

    __slots__ = ("footprint", "peaks", "bounds")

    def __init__(self, footprint, peaks, bounds):
        self.footprint = footprint
        self.peaks = peaks
        self.bounds = bounds


def get_connected_pixels(i, j, image, thresh=0):
    """Boolean mask of the 4-connected above-threshold region containing
    pixel (i, j), and its (bottom, top, left, right) bounds.

    Ref: detect_pybind11.cc:17-59 (iterative equivalent).
    """
    image = np.asarray(image)
    mask = image > thresh
    labels, _ = ndimage.label(mask,
                              structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    if not mask[i, j]:
        return np.zeros(image.shape, bool), np.array([i, i, j, j], np.int32)
    footprint = labels == labels[i, j]
    ys, xs = np.nonzero(footprint)
    bounds = np.array([ys.min(), ys.max(), xs.min(), xs.max()], np.int32)
    return footprint, bounds


def _find_peaks(patch, min_separation, y0, x0):
    """Strict 8-neighbor local maxima in ``patch``, brightest-first, with
    min-separation culling (brighter peak wins).

    Ref: detect_pybind11.cc:104-195.
    """
    H, W = patch.shape
    is_peak = np.ones(patch.shape, bool)
    for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                   (1, 0), (1, 1)):
        shifted = np.full(patch.shape, -np.inf)
        ys = slice(max(0, dy), H + min(0, dy))
        xs = slice(max(0, dx), W + min(0, dx))
        ys_src = slice(max(0, -dy), H + min(0, -dy))
        xs_src = slice(max(0, -dx), W + min(0, -dx))
        shifted[ys_src, xs_src] = patch[ys, xs]
        is_peak &= patch > shifted

    ys, xs = np.nonzero(is_peak)
    fluxes = patch[ys, xs]
    order = np.argsort(-fluxes, kind="stable")
    peaks = [Peak(ys[k] + y0, xs[k] + x0, fluxes[k]) for k in order]

    if min_separation > 0 and len(peaks) > 1:
        min_sep2 = min_separation * min_separation
        kept = []
        for p in peaks:
            if all((p.y - q.y) ** 2 + (p.x - q.x) ** 2 >= min_sep2
                   for q in kept):
                kept.append(p)
        peaks = kept
    return peaks


def get_footprints(image, min_separation, min_area, thresh):
    """All 4-connected above-threshold footprints of an image with their
    peaks, area-filtered.  Ref: detect_pybind11.cc:241-280.
    """
    image = np.asarray(image)
    labels, n = ndimage.label(image > thresh,
                              structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    footprints = []
    slices = ndimage.find_objects(labels)
    for idx, sl in enumerate(slices):
        if sl is None:
            continue
        sub = labels[sl] == (idx + 1)
        h = sl[0].stop - sl[0].start
        w = sl[1].stop - sl[1].start
        if h * w <= min_area or int(sub.sum()) < min_area:
            continue
        patch = np.where(sub, image[sl], 0)
        peaks = _find_peaks(patch, min_separation, sl[0].start, sl[1].start)
        bounds = np.array(
            [sl[0].start, sl[0].stop - 1, sl[1].start, sl[1].stop - 1],
            np.int32)
        footprints.append(Footprint(sub, peaks, bounds))
    return footprints


def bounds_to_bbox(bounds):
    """(bottom, top, left, right) -> Box. Ref: detect.py:15-26."""
    return Box(
        (int(bounds[1]) + 1 - int(bounds[0]),
         int(bounds[3]) + 1 - int(bounds[2])),
        origin=(int(bounds[0]), int(bounds[2])),
    )


def box_intersect(box1, box2):
    """True when two boxes overlap. Ref: detect.py:29-43."""
    overlap = box1 & box2
    return overlap.shape[0] != 0 and overlap.shape[1] != 0


def footprint_intersect(footprint1, box1, footprint2, box2):
    """True when two footprint masks overlap. Ref: detect.py:46-65."""
    if not box_intersect(box1, box2):
        return False
    slices1, slices2 = overlapped_slices(box1, box2)
    overlap = footprint1[slices1] * footprint2[slices2]
    return np.sum(overlap) > 0


# ---------------------------------------------------------------------------
# Spatial index: box quadtree
# ---------------------------------------------------------------------------
class QuadTreeRegion:
    """Quadtree over boxes (capacity-split, set-dedup query).

    Ref: scarlet/detect.py:115-297.
    """

    def __init__(self, bbox, capacity=5, sub_regions=None, boxes=None,
                 depth=0):
        self.bbox = bbox
        self.sub_regions = sub_regions
        self.boxes = boxes if boxes is not None else []
        self.capacity = capacity
        self.depth = depth

    def add(self, other_box):
        if not box_intersect(self.bbox, other_box):
            return
        if self.sub_regions is not None:
            self._add_to_sub_regions(other_box)
            return
        if self.boxes is None:
            self.boxes = []
        if len(self.boxes) < self.capacity - 1:
            self.boxes.append(other_box)
        else:
            self.split()
            self.boxes = None
            self._add_to_sub_regions(other_box)

    def add_footprints(self, footprints):
        for fp in footprints:
            box = bounds_to_bbox(fp.bounds)
            box.footprint = fp
            self.add(box)
        return self

    def split(self):
        height, width = self.bbox.shape
        h2, w2 = height // 2, width // 2
        h3, w3 = height - h2, width - w2
        origin = self.bbox.origin
        mk = lambda shape, org: QuadTreeRegion(  # noqa: E731
            Box(shape, org), capacity=self.capacity, depth=self.depth + 1)
        self.sub_regions = [
            mk((h2, w2), origin),
            mk((h3, w2), (origin[0] + h2, origin[1])),
            mk((h2, w3), (origin[0], origin[1] + w2)),
            mk((h3, w3), (origin[0] + h2, origin[1] + w2)),
        ]
        for box in self.boxes:
            self._add_to_sub_regions(box)

    def _add_to_sub_regions(self, other_box):
        for region in self.sub_regions:
            region.add(other_box)

    def query(self, other_box=None):
        if other_box is None:
            other_box = self.bbox
        if self.boxes is not None:
            return set(b for b in self.boxes if box_intersect(b, other_box))
        if self.sub_regions is not None:
            results = set()
            for region in self.sub_regions:
                if box_intersect(region.bbox, other_box):
                    results |= region.query(other_box)
            return results
        return set()

    def footprint_image(self, bbox=None):
        boxes = self.query(self.bbox)
        if bbox is None:
            bbox = Box((0, 0))
            for box in boxes:
                bbox = bbox | box
        footprint = np.zeros(bbox.shape)
        for box in boxes:
            full, local = overlapped_slices(bbox, box)
            footprint[full] += box.footprint.footprint[local]
        return footprint

    @property
    def peaks(self):
        for box in self.query(self.bbox):
            for peak in box.footprint.peaks:
                yield peak


class SingleScaleStructure:
    """A footprint at one wavelet scale plus overlapping footprints gathered
    from other scales.  Ref: scarlet/detect.py:300-384.
    """

    def __init__(self, scale, footprint):
        self.scale = scale
        self.footprint = footprint
        self.bbox = bounds_to_bbox(footprint.bounds)
        self.peaks = {scale: footprint.peaks}
        self._all_peaks = None

    def add_footprint(self, scale, footprint):
        if scale not in self.peaks:
            self.peaks[scale] = []
        self.peaks[scale] += footprint.peaks
        self._all_peaks = None

    def add_scale_tree(self, scale, tree):
        for box in tree.query(self.bbox):
            self.add_footprint(scale, box.footprint)
        return self

    @property
    def all_peaks(self):
        if self._all_peaks is None:
            all_peaks = set()
            for scale, peaks in self.peaks.items():
                all_peaks |= set((peak.x, peak.y) for peak in peaks)
            self._all_peaks = all_peaks
        return self._all_peaks


# ---------------------------------------------------------------------------
# Wavelet detection images
# ---------------------------------------------------------------------------
def get_wavelets(images, variance, scales=3):
    """Per-band significance-masked starlet coefficients
    (scales+1, bands, Ny, Nx).  Ref: detect.py:388-417.
    """
    sigma = np.median(np.sqrt(variance), axis=(1, 2))
    coeffs = []
    for b, image in enumerate(images):
        _coeffs = starlet_transform(torch.from_numpy(np.array(image)),
                                    scales=scales).numpy()
        M = get_multiresolution_support(image, _coeffs, sigma[b], K=3,
                                        epsilon=1e-1, max_iter=20)
        coeffs.append(M * _coeffs)
    return np.array(coeffs).swapaxes(0, 1)


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


def get_blend_trees(detect):
    """Quadtree + footprints per wavelet scale. Ref: detect.py:461-487."""
    all_footprints = [
        get_footprints(_detect, min_separation=0, min_area=4, thresh=0)
        for _detect in detect[:-1]
    ]
    trees = [
        QuadTreeRegion(Box(detect.shape[-2:]), capacity=10).add_footprints(fps)
        for fps in all_footprints
    ]
    return trees, all_footprints


def get_blend_structures(detect):
    """Structures linking 3rd-scale footprints to overlapping lower-scale
    footprints.  Ref: detect.py:491-514 (the live second definition).
    """
    all_footprints = [
        get_footprints(_detect, min_separation=0, min_area=4, thresh=0)
        for _detect in detect[:-1]
    ]
    low, middle = all_footprints[:2]
    low_tree = QuadTreeRegion(Box(detect.shape[-2:]),
                              capacity=10).add_footprints(low)
    middle_tree = QuadTreeRegion(Box(detect.shape[-2:]),
                                 capacity=10).add_footprints(middle)
    high_structures = [
        SingleScaleStructure(2, fp)
        .add_scale_tree(0, low_tree)
        .add_scale_tree(1, middle_tree)
        for fp in all_footprints[2]
    ]
    return high_structures, middle_tree


def get_peaks(detect=None, images=None, variance=None, bbox=None, scales=3):
    """All peaks detected at the 2nd wavelet scale. Ref: detect.py:517-572."""
    if detect is None:
        if images is None or variance is None:
            raise ValueError(
                "Must pass either 'detect' or 'images' and 'variance'")
        detect = get_detect_wavelets(images, variance, scales=scales)

    if bbox is None:
        bbox = Box(detect.shape[1:])
    else:
        bbox = bbox[1:]

    _, tree = get_blend_structures(detect)
    peaks = []
    for box in tree.query(bbox):
        for peak in box.footprint.peaks:
            peaks.append((peak.y, peak.x))
    return peaks
