"""The host side of the monotonicity projection kernel (K1/K2, K5, K6 in
``scarlet_tpu_torch/ops/csrc/mono.cu``), on the CPU: the compact tap
table it reads (``kernels.mono_taps``), the plain projection on that
table (the kernel's arithmetic, ``monotonic_prox_taps_plain``) against
``monotonic_prox_plain`` bit for bit, the stated inf/NaN behaviour, and
the launch geometry (``kernels.mono_geometry``), which must cover each
pixel of a box once.  The kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from scarlet_tpu_torch.lite import engine
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.ops.prox import NEIGHBOR_OFFSETS


def _tables(box, weight="angle"):
    shape = (box, box) if isinstance(box, int) else box
    w, keep, n_iter = engine.monotonicity_tables(shape, 1, weight)
    return w.astype(np.float32), keep.astype(np.float32), n_iter


def _dense(taps):
    """The (ncand, 8, hb, wb) table that ``taps`` encodes."""
    ncand, hb, wb, T = taps.weights.shape
    out = np.zeros((ncand, 8, hb, wb), np.float32)
    count = taps.codes & 15
    for t in range(T):
        d = (taps.codes >> (4 + 3 * t)) & 7
        on = t < count
        c, y, x = np.nonzero(on)
        out[c, d[on], y, x] = taps.weights[..., t][on]
    return out


@pytest.mark.parametrize("weight", ["angle", "flat", "nearest"])
@pytest.mark.parametrize("box", [21, 31, 41, 59, 69, (21, 31)])
def test_taps_keep_exactly_the_nonzero_weights_in_d_order(box, weight):
    w, keep, _ = _tables(box, weight)
    taps = kn.mono_taps(w, keep)
    assert taps.T == 4
    np.testing.assert_array_equal(taps.codes & 15, (w != 0).sum(axis=1))
    np.testing.assert_array_equal(_dense(taps), w)
    # d order: the directions of a pixel's taps strictly increase
    count = taps.codes & 15
    for t in range(1, taps.T):
        later = t < count
        d0 = (taps.codes >> (4 + 3 * (t - 1))) & 7
        d1 = (taps.codes >> (4 + 3 * t)) & 7
        assert (d1[later] > d0[later]).all()
    # zero-padded beyond the count
    for t in range(taps.T):
        assert (taps.weights[..., t][t >= count] == 0).all()
    hb, wb = w.shape[-2:]
    np.testing.assert_array_equal(
        taps.centers, keep.reshape(len(keep), -1).argmax(axis=1))
    assert taps.weights.dtype == np.float32 and taps.codes.dtype == np.int32


def test_taps_raise_beyond_T_and_without_one_keep_pixel():
    w, keep, _ = _tables(21)
    w = w.copy()
    w[0, :5, 3, 3] = 0.2                       # five taps at one pixel
    with pytest.raises(ValueError, match="more than T=4"):
        kn.mono_taps(w, keep, T=4)
    taps = kn.mono_taps(w, keep)               # T=8 takes it
    assert taps.T == 8
    np.testing.assert_array_equal(_dense(taps), w)
    two = keep.copy()
    two[1, 0, 0] = 1.0
    with pytest.raises(ValueError, match="one keep"):
        kn.mono_taps(_tables(21)[0], two)


def _inputs(box, seed, B=2, K=5):
    """Seeded morphologies: noisy peaked profiles, one (blend 0, slot 0)
    already at its fixed point, so it exits after one block of 4 passes,
    and one (the last) of uniform noise, which runs to n_iter; the
    candidate of each picked at random."""
    w, keep, n_iter = _tables(box)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:box, :box] - box // 2
    m = np.exp(-(yy ** 2 + xx ** 2) / rng.uniform(2, 30, (B, K, 1, 1)))
    m = m * (1 + 0.3 * rng.uniform(size=(B, K, box, box)))
    m[-1, -1] = rng.uniform(size=(box, box))
    m = torch.from_numpy(m.astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, (B, K)))
    wt, kt = torch.from_numpy(w), torch.from_numpy(keep)
    m[0, 0] = kn.monotonic_prox_plain(m[0, 0], idx[0, 0], wt, kt, n_iter)
    return m, idx, wt, kt, n_iter


def _passes(m, idx, wt, kt, n_iter, tol):
    """Passes each morphology runs under the exit rule."""
    runs = []
    for x, i in zip(m.reshape(-1, *m.shape[-2:]), idx.reshape(-1)):
        count = [0]
        w, keep = wt[i], kt[i] > 0.5

        def one_pass(y):
            count[0] += 1
            return kn._mono_pass(y, x, w, keep, 1.0)

        kn._mono_blocks(x, n_iter, tol, one_pass)
        runs.append(count[0])
    return runs


@pytest.mark.parametrize("depth", ["8", "full"])
@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("box", [21, 31, 41, 59])
def test_plain_on_taps_equals_plain_bitwise(box, tol, depth):
    m, idx, wt, kt, n_iter = _inputs(box, seed=box)
    n_iter = 8 if depth == "8" else n_iter
    taps = kn.mono_taps(wt.numpy(), kt.numpy())
    ref = kn.monotonic_prox_plain(m, idx, wt, kt, n_iter, tol=tol)
    got = kn.monotonic_prox_taps_plain(m, idx, taps, n_iter, tol=tol)
    assert torch.equal(got, ref)
    # min_gradient scales each reference sum
    ref = kn.monotonic_prox_plain(m, idx, wt, kt, n_iter, 0.1, tol)
    assert torch.equal(
        kn.monotonic_prox_taps_plain(m, idx, taps, n_iter, 0.1, tol), ref)
    runs = _passes(m, idx, wt, kt, n_iter, tol)
    assert runs[0] == kn.MONO_UNROLL
    if depth == "8":
        assert runs[-1] == n_iter


def test_packed_plain_on_taps_layout():
    """The packed (B, hb, K*wb) plain version is the unpacked one."""
    m, idx, wt, kt, n_iter = _inputs(21, seed=3)
    B, K, hb, wb = m.shape
    packed = m.transpose(-3, -2).reshape(B, hb, K * wb)
    got = kn.monotonic_prox_packed_plain(packed, idx, wt, kt, wb, n_iter)
    ref = kn.monotonic_prox_plain(m, idx, wt, kt, n_iter)
    assert torch.equal(got.reshape(B, hb, K, wb).transpose(-3, -2), ref)


def test_zero_taps_ignore_non_finite_neighbours():
    """The stated difference: an inf neighbour with weight 0 makes the
    plain version's pixel NaN (0 * inf) and the spread reaches the
    pixels that reference it; the kernel's arithmetic never reads it and
    stays finite.  Morphologies on the port's paths are finite."""
    m, idx, wt, kt, n_iter = _inputs(21, seed=4, B=1, K=1)
    m[0, 0, 0, 0] = float("inf")               # a corner: weight 0 from
    taps = kn.mono_taps(wt.numpy(), kt.numpy())  # its inner neighbours
    ref = kn.monotonic_prox_plain(m, idx, wt, kt, n_iter)
    got = kn.monotonic_prox_taps_plain(m, idx, taps, n_iter)
    assert torch.isnan(ref[0, 0, 1, 1])
    assert torch.isfinite(got).all()
    fin = torch.isfinite(ref)
    assert torch.equal(got[fin], ref[fin])


def _cover(geom, hb, wb):
    """The pixels of an (hb, wb) box each thread of the kernel's map
    takes (csrc/mono.cu ``geometry`` and ``slot_yx``): counts (hb, wb)."""
    seen = np.zeros((hb, wb), int)
    tid = np.arange(geom.threads)
    tx, ty = tid % geom.W, tid // geom.W
    for j in range(geom.P):
        r = ty + j * geom.ny
        on = (ty < geom.ny) & (r < geom.H)
        y, x = (tx, r) if geom.transposed else (r, tx)
        np.add.at(seen, (y[on], x[on]), 1)
    return seen


@pytest.mark.parametrize("shape", [(b, b) for b in range(21, 70)]
                         + [(21, 31), (31, 21), (59, 61), (9, 200)])
def test_geometry_covers_each_pixel_once(shape):
    hb, wb = shape
    g = kn.mono_geometry(hb, wb)
    assert (_cover(g, hb, wb) == 1).all()
    assert g.threads % 32 == 0 and g.threads <= kn.MONO_MAX_THREADS
    assert g.P in kn.MONO_SLOTS and g.ny * g.P >= g.H
    assert g.transposed == (wb > hb) and g.W == min(hb, wb)
    assert g.smem == 3 * (hb + 2) * (wb + 2) * 4 <= kn.SMEM_LIMIT


def test_geometry_takes_every_box_the_block_design_took():
    """Every (hb, wb) with hb * wb * 48 <= 232,448 (the shared-memory
    rule of the one-block-per-SM design) fits, and the taps' byte
    offsets (at most W + 3) fit a signed byte."""
    limit = 232448 // 48
    for hb in range(1, limit + 1):
        for wb in range(1, limit // hb + 1):
            g = kn.mono_geometry(hb, wb)
            assert g.W + 3 <= 127
    assert kn.mono_geometry(59, 59)[3:6] == (8, 8, 480)  # ny, P, threads
    with pytest.raises(ValueError, match="does not fit"):
        kn.mono_geometry(74, 74)


def test_device_taps_are_built_once_per_table():
    w, keep, _ = _tables(21)
    wt, kt = torch.from_numpy(w.copy()), torch.from_numpy(keep)
    a = kn._device_taps(wt, kt)
    assert kn._device_taps(wt, kt) is a
    assert a.weights.device == wt.device
    wt[0, 0, 0, 0] = 0.5                        # written: built again
    b = kn._device_taps(wt, kt)
    assert b is not a and b.weights[0, 0, 0, 0] == 0.5
    np.testing.assert_array_equal(b.codes.numpy()[1:], a.codes.numpy()[1:])


def test_neighbor_directions_match_the_kernel():
    """csrc/mono.cu decodes direction d as NEIGHBOR_OFFSETS[d]."""
    dy = [-1 if d < 3 else (0 if d < 5 else 1) for d in range(8)]
    dx = [-1 if d in (0, 3, 5) else (0 if d in (1, 6) else 1)
          for d in range(8)]
    assert list(zip(dy, dx)) == list(NEIGHBOR_OFFSETS)
