"""The port's host detection (``scarlet_tpu_torch.detect``) against the JAX
package's on the CPU.

Inputs: two ``generate_blend`` blends of the object tree's size (5, 58,
48) with 7 sources (seeds 11 and 12), their variance, and the
significance-masked starlet coefficients of their band sum.

Tolerance: none.  The transforms are bit for bit (tests/test_torch_starlet.py)
and the rest is the same numpy and scipy code, so every peak (its
position, flux and order), bound, footprint mask and structure is equal.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import scarlet_tpu as st
from scarlet_tpu import detect as jd
from scarlet_tpu.testing.blendsets import generate_blend
from scarlet_tpu_torch import detect as td
from scarlet_tpu_torch.bbox import Box

SEEDS = (11, 12)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=SEEDS)
def blend(request):
    d = generate_blend(np.random.default_rng(request.param),
                       shape=(5, 58, 48), n_sources=7)
    images = d["images"].astype(np.float32)
    variance = d["variance"].astype(np.float32)
    detect = jd.get_detect_wavelets(images, variance)
    return images, variance, detect


def _peaks(peaks):
    return [(p.y, p.x, p.flux) for p in peaks]


def _same_footprints(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _peaks(g.peaks) == _peaks(r.peaks)
        assert_array_equal(g.bounds, r.bounds)
        assert g.bounds.dtype == r.bounds.dtype
        assert_array_equal(g.footprint, r.footprint)


def test_detect_wavelets_equal(blend):
    images, variance, detect = blend
    assert_array_equal(td.get_detect_wavelets(images, variance), detect)
    got = td.get_wavelets(images, variance)
    ref = jd.get_wavelets(images, variance)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (4, 5, 58, 48)
    assert_array_equal(got, ref)


@pytest.mark.parametrize("min_separation, min_area, thresh",
                         [(0, 4, 0), (3, 10, 0), (2, 4, 0.05)])
def test_footprints_equal(blend, min_separation, min_area, thresh):
    _, _, detect = blend
    n = 0
    for plane in detect[:3]:
        ref = jd.get_footprints(plane, min_separation, min_area, thresh)
        _same_footprints(
            td.get_footprints(plane, min_separation, min_area, thresh), ref)
        n += len(ref)
    assert n > 0


def test_connected_pixels_and_intersections(blend):
    _, _, detect = blend
    plane = detect[1]
    fps = td.get_footprints(plane, 0, 4, 0)
    for fp in fps[:4]:
        y, x = fp.peaks[0].y, fp.peaks[0].x
        got, gb = td.get_connected_pixels(y, x, plane)
        ref, rb = jd.get_connected_pixels(y, x, plane)
        assert_array_equal(got, ref)
        assert_array_equal(gb, rb)
    # a pixel below the threshold: an empty mask
    off = np.unravel_index(np.argmin(plane), plane.shape)
    got, gb = td.get_connected_pixels(*off, plane)
    ref, rb = jd.get_connected_pixels(*off, plane)
    assert not got.any()
    assert_array_equal(gb, rb)
    boxes = [td.bounds_to_bbox(f.bounds) for f in fps]
    jboxes = [jd.bounds_to_bbox(f.bounds) for f in fps]
    for i in range(len(fps)):
        for j in range(len(fps)):
            assert td.box_intersect(boxes[i], boxes[j]) == \
                jd.box_intersect(jboxes[i], jboxes[j])
            assert td.footprint_intersect(
                fps[i].footprint, boxes[i], fps[j].footprint, boxes[j]) == \
                jd.footprint_intersect(fps[i].footprint, jboxes[i],
                                       fps[j].footprint, jboxes[j])


def test_blend_trees_and_structures_equal(blend):
    _, _, detect = blend
    trees, fps = td.get_blend_trees(detect)
    jtrees, jfps = jd.get_blend_trees(detect)
    for got, ref in zip(fps, jfps):
        _same_footprints(got, ref)
    assert sum(len(f) for f in jfps) > 0
    for t, j in zip(trees, jtrees):
        assert sorted(_peaks(t.peaks)) == sorted(_peaks(j.peaks))
        assert_array_equal(t.footprint_image(), j.footprint_image())
    structures, middle = td.get_blend_structures(detect)
    jstructures, jmiddle = jd.get_blend_structures(detect)
    assert len(structures) == len(jstructures) > 0
    for s, j in zip(structures, jstructures):
        assert (s.bbox.shape, s.bbox.origin) == (j.bbox.shape, j.bbox.origin)
        assert sorted(s.peaks) == sorted(j.peaks)
        for scale in j.peaks:
            assert _peaks(s.peaks[scale]) == _peaks(j.peaks[scale])
        assert s.all_peaks == j.all_peaks
    assert [(b.shape, b.origin) for b in middle.query()] == \
        [(b.shape, b.origin) for b in jmiddle.query()]


def test_quadtree_split_and_query():
    """More boxes than the capacity: the region splits; queries return the
    same boxes in the same order."""
    rng = np.random.default_rng(3)
    fps = []
    for _ in range(30):
        y0, x0 = rng.integers(0, 50, 2)
        h, w = rng.integers(2, 9, 2)
        fps.append(jd.Footprint(np.ones((h, w), bool),
                                [jd.Peak(y0, x0, 1.0)],
                                np.array([y0, y0 + h - 1, x0, x0 + w - 1],
                                         np.int32)))
    tfps = [td.Footprint(f.footprint, [td.Peak(p.y, p.x, p.flux)
                                       for p in f.peaks], f.bounds)
            for f in fps]
    t = td.QuadTreeRegion(Box((60, 60)), capacity=4).add_footprints(tfps)
    j = jd.QuadTreeRegion(st.Box((60, 60)), capacity=4).add_footprints(fps)
    assert t.sub_regions is not None and j.sub_regions is not None
    for q in (Box((10, 12), (5, 7)), Box((60, 60)), None):
        jq = None if q is None else st.Box(q.shape, q.origin)
        assert [(b.shape, b.origin) for b in t.query(q)] == \
            [(b.shape, b.origin) for b in j.query(jq)]
    assert_array_equal(t.footprint_image(Box((60, 60))),
                       j.footprint_image(st.Box((60, 60))))


def test_get_peaks_equal(blend):
    images, variance, detect = blend
    got = td.get_peaks(images=images, variance=variance)
    ref = jd.get_peaks(images=images, variance=variance)
    assert got == ref and len(ref) > 0
    assert td.get_peaks(detect) == jd.get_peaks(detect)
    # a 3-D box: its last two axes bound the query
    box = Box((5, 30, 24), (0, 10, 12))
    assert td.get_peaks(detect, bbox=box) == jd.get_peaks(
        detect, bbox=st.Box(box.shape, box.origin))
    with pytest.raises(ValueError):
        td.get_peaks(images=images)
