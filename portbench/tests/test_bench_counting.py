"""The counting functions on shapes worked by hand."""
from __future__ import annotations

import math

import numpy as np
import pytest

from portbench import counting
from portbench.counting import Work

# two blends: 10 and 20 iterations, 2 and 1 active components
WORK = Work(iterations=np.array([10.0, 20.0]),
            components=np.array([2.0, 1.0]),
            inscene_pixels=np.array([100.0, 30.0]),
            catalog_rows=np.array([1.0, 1.0]))


def test_inscene_pixels():
    org = np.array([[0, 0], [-2, -3], [8, 9], [20, 20]])
    # box 5 in a 10 x 12 scene: whole; 3 x 2; 2 x 3; outside
    assert counting.inscene_pixels(org, 5, (10, 12)).tolist() == \
        [25, 6, 6, 0]


def test_bound_and_share():
    assert counting.bound_s(3.35e12) == pytest.approx(1.0)
    assert counting.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counting.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert counting.share_pct(0.5, 2.0) == pytest.approx(25.0)
    assert counting.share_pct(0.5, 0.0) is None


def test_k1_bytes():
    # box 3: 9 pixels, 36 bytes a morphology; fit (10*2 + 20*1) = 40
    # morphology-iterations read and written, init 2 rows, 1 launch of 9
    # candidates' taps (9 * (9 * 20 + 4))
    assert counting.k1_bytes(WORK, 3, 1) == \
        40 * 72 + 2 * 72 + 9 * (9 * 20 + 4)


def test_k3_bytes():
    # scene (2, 4, 5): 160 bytes an iteration; plus in-scene pixels and
    # SEDs (2 bands) of the components
    per = np.array([160 + (100 + 2 * 2) * 4, 160 + (30 + 1 * 2) * 4])
    assert counting.k3_bytes(WORK, (2, 4, 5)) == float(
        np.sum(WORK.iterations * per))


def test_k4_bytes():
    # gradient 160 bytes; per component in-scene pixels read, box 3's 9
    # pixels written, SED read and its gradient written (2 * 2 bands)
    per = np.array([160 + (100 + 2 * (9 + 4)) * 4,
                    160 + (30 + 1 * (9 + 4)) * 4])
    assert counting.k4_bytes(WORK, (2, 4, 5), 3) == float(
        np.sum(WORK.iterations * per))


def test_fit_work():
    nbytes, nops = counting.fit_work(WORK, (2, 4, 5), 3, (8, 8))
    params = (9 + 2) * 4 * 3 * 2
    assert nbytes == 10 * (2 * 160 + 2 * params) + 20 * (2 * 160 + params)
    rfft = 2.5 * 64 * 6
    assert counting.rfft2_ops((8, 8)) == rfft
    per_iter = 2 * 2 * (2 * rfft + 6 * 8 * 5)
    assert nops == 30 * per_iter
    assert math.isclose(counting.bound_s(nbytes, nops),
                        max(nbytes / 3.35e12, nops / 67e12))


def test_work_adds_calls():
    both = WORK + WORK
    assert both.iterations.tolist() == [10, 20, 10, 20]
    assert counting.k3_bytes(both, (2, 4, 5)) == \
        2 * counting.k3_bytes(WORK, (2, 4, 5))
