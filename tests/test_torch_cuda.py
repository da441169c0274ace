"""The CUDA kernels of scarlet_tpu_torch against their plain PyTorch
versions, on the card.  Every test is marked ``cuda`` and skips without a
CUDA device.

This file imports no JAX, so it runs where JAX is not installed (the
tests' conftest imports JAX, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scarlet_tpu_torch import lite
from scarlet_tpu_torch.lite import engine
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.testing import generate_blend

BOX = 59


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(box=BOX):
    box = (box, box) if isinstance(box, int) else box
    w, keep, n_iter = engine.monotonicity_tables(box, 1, "angle")
    return (torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(keep.astype(np.float32)), n_iter)


def _morphs(B, K, box=BOX, seed=0):
    """Noisy peaked profiles with an argmax tie in the first morph's 3x3
    center window; returns (morphs, first-argmax table index)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:box, :box] - box // 2
    scale = rng.uniform(2, 30, (B, K, 1, 1))
    m = np.exp(-(yy ** 2 + xx ** 2) / scale) * (
        1 + 0.3 * rng.uniform(size=(B, K, box, box)))
    c = box // 2
    m[0, 0, c - 1:c + 2, c - 1:c + 2] = 1.5
    m = torch.from_numpy(m.astype(np.float32))
    idx = m[..., c - 1:c + 2, c - 1:c + 2].reshape(B, K, 9).argmax(-1)
    assert int(idx[0, 0]) == 0
    return m, idx


@pytest.mark.cuda
@pytest.mark.parametrize("depth", ["4", "full"])
@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("box", [21, 41, 59, 69])
def test_monotonic_prox_matches_plain(cuda, box, tol, depth):
    """K1 and its packed layout (K2) bit for bit against the plain
    version, at 4 passes and at the box's full depth."""
    w, keep, n_iter = _tables(box)
    n_iter = 4 if depth == "4" else n_iter
    m, idx = _morphs(2, 16, box)
    args = [x.to(cuda) for x in (m, idx, w, keep)]
    before = kn.monotonic_prox.launches
    got = kn.monotonic_prox(*args, n_iter, tol=tol)
    assert kn.monotonic_prox.launches == before + 1
    assert torch.equal(got, kn.monotonic_prox_plain(*args, n_iter, tol=tol))
    packed = args[0].transpose(-3, -2).reshape(2, box, 16 * box).contiguous()
    got_p = kn.monotonic_prox_packed(packed, *args[1:], box, n_iter,
                                     tol=tol)
    assert torch.equal(got_p, kn.monotonic_prox_packed_plain(
        packed, *args[1:], box, n_iter, tol=tol))
    assert torch.equal(got_p.reshape(2, box, 16, box).transpose(-3, -2),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(21, 31), (31, 21), (9, 200)])
def test_monotonic_prox_non_square_matches_plain(cuda, shape):
    """Boxes wider than tall run on the transposed frame."""
    hb, wb = shape
    w, keep, n_iter = _tables(shape)
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.uniform(size=(3, 4, hb, wb)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 9, (3, 4)))
    args = [x.to(cuda) for x in (m, idx, w, keep)]
    for tol in (0.0, 1e-3):
        assert torch.equal(kn.monotonic_prox(*args, n_iter, tol=tol),
                           kn.monotonic_prox_plain(*args, n_iter, tol=tol))


def _chain_inputs(cuda, B=3, K=16, seed=2, box=BOX):
    """Stepped morphs, moments and per-slot rows for K5/K6: some gates
    off, nonzero thresholds, an argmax tie, box masks cutting columns,
    blend 0 at its first iteration."""
    rng = np.random.default_rng(seed)
    m, _ = _morphs(B, K, box, seed=seed)
    shape = (B, K, box, box)
    g = torch.from_numpy((0.1 * rng.normal(size=shape)).astype(np.float32))
    mom = [torch.from_numpy((0.05 * rng.normal(size=shape)).astype(
        np.float32))] + [torch.from_numpy((0.01 * rng.uniform(
            size=shape)).astype(np.float32)) for _ in range(2)]
    bm = torch.ones(shape)
    bm[:, 1::3, :, :6] = 0.0
    gate = torch.from_numpy(rng.uniform(size=(B, K)) > 0.25)
    thr = torch.from_numpy(np.where(rng.uniform(size=(B, K)) > 0.5,
                                    rng.uniform(0.01, 0.2, (B, K)),
                                    0.0).astype(np.float32))
    it = torch.arange(B, dtype=torch.int32) * 3
    ds = torch.where(it > 0, 1.0, 0.1) * 1e-2
    return [x.to(cuda) for x in (m, g, *mom, bm, gate, thr, ds)]


@pytest.mark.cuda
@pytest.mark.parametrize("box", [21, 59, 69])
@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_prox_chain_matches_plain(cuda, tol, box):
    w, keep, n_iter = (x.to(cuda) if torch.is_tensor(x) else x
                       for x in _tables(box))
    m, g, _, _, _, bm, gate, thr, _ = _chain_inputs(cuda, box=box)
    stepped = (m + g) * bm
    idx = kn.candidate_index(stepped, 1)
    before = kn.prox_chain.launches
    got = kn.prox_chain(m, stepped, idx, w, keep, thr, gate, n_iter, tol=tol)
    assert kn.prox_chain.launches == before + 1
    assert torch.equal(got, kn.prox_chain_plain(m, stepped, idx, w, keep,
                                                thr, gate, n_iter, tol=tol))
    assert torch.equal(got[~gate], m[~gate])


@pytest.mark.cuda
@pytest.mark.parametrize("box", [21, 59, 69])
def test_fused_morph_update_matches_plain(cuda, box):
    w, keep, n_iter = (x.to(cuda) if torch.is_tensor(x) else x
                       for x in _tables(box))
    m, g, m1, v, vh, bm, gate, thr, ds = _chain_inputs(cuda, box=box)
    opt = engine.AdaproxState(m1, v, vh)
    before = kn.fused_morph_update.launches
    for masks in (bm, None):
        x, o = kn.fused_morph_update(m, g, opt, gate, w, keep, masks, thr,
                                     ds, n_iter)
        rx, ro = kn.fused_morph_update_plain(m, g, opt, gate, w, keep, masks,
                                             thr, ds, n_iter)
        assert torch.equal(x, rx)
        for a, b in zip(o, ro):
            assert torch.equal(a, b)
    assert kn.fused_morph_update.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("box", [81, 101])
def test_prox_chain_and_fused_update_take_wide_boxes(cuda, box):
    """K5 and K6 on boxes beyond ``mono_geometry`` (over 73 pixels a
    side) run the wide engine's ``chain_kernel_wide`` and
    ``fused_kernel_wide``: bit for bit with the twins on the card, one
    launch per call, counted as each wrapper's wide launch and not as a
    launch of its register kernel or of K1."""
    with pytest.raises(ValueError):
        kn.mono_geometry(box, box)
    w, keep, n_iter = (x.to(cuda) if torch.is_tensor(x) else x
                       for x in _tables(box))
    m, g, m1, v, vh, bm, gate, thr, ds = _chain_inputs(cuda, B=2, K=4,
                                                       box=box)
    stepped = (m + g) * bm
    idx = kn.candidate_index(stepped, 1)
    kn.reset_launch_counts()
    for tol in (0.0, 1e-3):
        got = kn.prox_chain(m, stepped, idx, w, keep, thr, gate, n_iter,
                            tol=tol)
        assert torch.equal(got, kn.prox_chain_plain(
            m, stepped, idx, w, keep, thr, gate, n_iter, tol=tol))
    opt = engine.AdaproxState(m1, v, vh)
    for masks in (bm, None):
        x, o = kn.fused_morph_update(m, g, opt, gate, w, keep, masks, thr,
                                     ds, n_iter)
        rx, ro = kn.fused_morph_update_plain(m, g, opt, gate, w, keep, masks,
                                             thr, ds, n_iter)
        assert torch.equal(x, rx)
        for a, b in zip(o, ro):
            assert torch.equal(a, b)
    counts = kn.launch_counts()
    assert counts["prox_chain_wide"] == counts["fused_morph_update_wide"] \
        == 2
    assert counts["prox_chain"] == counts["fused_morph_update"] == 0
    assert counts["monotonic_prox_wide"] == counts["monotonic_prox"] == 0


# boxes beyond mono_geometry and morphologies per launch (B, K): on an
# H100, R runs 16 (B K = 1, 4) and 2, 4 or 8 (32, 256: as few as the
# band's fit needs)
WIDE_BOXES = [74, 81, 101, 128, 150, (77, 130)]
WIDE_COUNTS = [(1, 1), (1, 4), (2, 16), (16, 16)]


def _wide_inputs(cuda, B, K, box, radius, seed):
    """Seeded wide-box inputs: peaked noisy profiles whose center window
    holds the peak, moments, box masks cutting columns, thresholds, a
    gate with slot 0 on and (B K > 1) some slots off."""
    hb, wb = (box, box) if isinstance(box, int) else box
    w, keep, n_iter = engine.monotonicity_tables((hb, wb), radius, "angle")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hb, :wb]
    prof = np.exp(-((yy - hb // 2) ** 2 + (xx - wb // 2) ** 2)
                  / rng.uniform(50, 800, (B, K, 1, 1)))
    shape = (B, K, hb, wb)
    m = prof * (1 + 0.3 * rng.uniform(size=shape))
    g = 0.1 * rng.normal(size=shape)
    mom = [0.05 * rng.normal(size=shape), 0.01 * rng.uniform(size=shape),
           0.01 * rng.uniform(size=shape)]
    bm = np.ones(shape)
    bm[:, 1::3, :, :6] = 0.0
    gate = rng.uniform(size=(B, K)) > 0.25
    gate[0, 0] = True
    thr = np.where(rng.uniform(size=(B, K)) > 0.5,
                   rng.uniform(0.01, 0.2, (B, K)), 0.0)
    ds = np.where(np.arange(B) > 0, 1.0, 0.1) * 1e-2
    f32 = [torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
           for a in (w, keep, m, g, *mom, bm, thr, ds)]
    return (*f32[:2], n_iter, *f32[2:], torch.from_numpy(gate).to(cuda))


def _straddles(geo, hb, wb, radius):
    """Whether the (2r+1)^2 center window crosses a band boundary."""
    lo, hi = ((wb // 2 - radius, wb // 2 + radius) if geo.transposed
              else (hb // 2 - radius, hb // 2 + radius))
    return any(lo < start <= hi for start, _ in geo.bands())


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", WIDE_COUNTS, ids=lambda v: str(v))
@pytest.mark.parametrize("box", WIDE_BOXES, ids=str)
def test_wide_kernels_match_plain_at_every_cluster_size(cuda, box, B, K):
    """The wide engine's three kernels bit for bit against their plain
    versions at each box and cluster size R (the register route):
    :func:`_check_wide_kernels`.  At 128 px and R = 16 the center
    windows of r = 1 and r = 2 straddle two bands."""
    hb, wb = (box, box) if isinstance(box, int) else box
    geo = kn._card_geometry(cuda, B * K, hb, wb)
    assert geo.P > 0 and not geo.workspace
    straddled = _check_wide_kernels(cuda, hb, wb, B, K)
    if geo.R == 16 and box == 128:
        assert all(straddled)       # rows 63-65 and 62-66 cross row 64


@pytest.mark.cuda
@pytest.mark.parametrize("box,B,K,workspace", [(300, 1, 1, False),
                                               (300, 1, 4, False),
                                               (540, 1, 1, True)])
def test_wide_kernels_stream_past_the_register_slots(cuda, box, B, K,
                                                     workspace):
    """Bands too large for the register slots stream their taps, their
    planes in shared memory (300 px) or, past what 16 CTAs hold, in the
    device-memory workspace (540 px): the three kernels bit for bit as
    in :func:`_check_wide_kernels`."""
    geo = kn._card_geometry(cuda, B * K, box, box)
    assert geo.P == 0 and geo.workspace == workspace
    _check_wide_kernels(cuda, box, box, B, K)


@pytest.mark.cuda
def test_wide_kernels_one_cta_per_morphology(cuda):
    """Past what 16 CTAs hold (540 px) with more morphologies than the
    card holds clusters of two, R = 1: a cluster of one CTA per
    morphology (the engine's block barrier, and its exit test and max
    without DSMEM), the planes in the workspace; the three kernels bit for
    bit as in :func:`_check_wide_kernels`."""
    index = cuda.index if cuda.index is not None \
        else torch.cuda.current_device()
    K = 8
    B = kn._card(index)[1][2] // K + 1          # 9 on an H100 (66 pairs)
    geo = kn._card_geometry(cuda, B * K, 540, 540)
    assert geo.R == 1 and geo.P == 0 and geo.workspace
    _check_wide_kernels(cuda, 540, 540, B, K)


def _check_wide_kernels(cuda, hb, wb, B, K):
    """K1 at tol 0, 1e-3 and one tolerance per blend, and in the strided
    (packed) layout; K5 at tol 0 and 1e-3 with gated-off slots; K6 with
    and without box masks at r = 1 and r = 2; each bit for bit against
    its plain version, one wide launch per call, none of K1 from K5 or
    K6.  Returns, per radius, whether the center window crosses a band
    boundary."""
    geo = kn._card_geometry(cuda, B * K, hb, wb)
    straddled = []
    for radius in (1, 2):
        (w, keep, n_iter, m, g, m1, v, vh, bm, thr, ds,
         gate) = _wide_inputs(cuda, B, K, (hb, wb), radius, hb + B)
        stepped = (m + g) * bm
        idx = kn.candidate_index(stepped, radius)
        if radius == 1:
            tols = torch.tensor([0.0, 1e-3] * B, device=cuda)[:B]
            for tol in (0.0, 1e-3, tols):
                before = kn.launch_counts()
                got = kn.monotonic_prox(stepped, idx, w, keep, n_iter,
                                        tol=tol)
                after = kn.launch_counts()
                assert after["monotonic_prox_wide"] == \
                    before["monotonic_prox_wide"] + 1
                assert torch.equal(got, kn.monotonic_prox_plain(
                    stepped, idx, w, keep, n_iter, tol=tol))
            packed = stepped.transpose(-3, -2).reshape(B, hb, K * wb) \
                .contiguous()
            got_p = kn.monotonic_prox_packed(packed, idx, w, keep, wb,
                                             n_iter)
            assert torch.equal(got_p, kn.monotonic_prox_packed_plain(
                packed, idx, w, keep, wb, n_iter))
            for tol in (0.0, 1e-3):
                kn.reset_launch_counts()
                got = kn.prox_chain(m, stepped, idx, w, keep, thr, gate,
                                    n_iter, tol=tol)
                assert kn.launch_counts()["prox_chain_wide"] == 1
                assert torch.equal(got, kn.prox_chain_plain(
                    m, stepped, idx, w, keep, thr, gate, n_iter, tol=tol))
                assert torch.equal(got[~gate], m[~gate])
        opt = engine.AdaproxState(m1, v, vh)
        for masks in (bm, None):
            kn.reset_launch_counts()
            x, o = kn.fused_morph_update(m, g, opt, gate, w, keep, masks,
                                         thr, ds, n_iter,
                                         fit_center_radius=radius)
            counts = kn.launch_counts()
            assert counts["fused_morph_update_wide"] == 1
            assert counts["monotonic_prox"] == counts["prox_chain"] == 0
            rx, ro = kn.fused_morph_update_plain(
                m, g, opt, gate, w, keep, masks, thr, ds, n_iter,
                fit_center_radius=radius)
            assert torch.equal(x, rx)
            for a, b in zip(o, ro):
                assert torch.equal(a, b)
        straddled.append(_straddles(geo, hb, wb, radius))
    return straddled


@pytest.mark.cuda
@pytest.mark.parametrize("box", [81, 128])
def test_wide_kernels_skip_gated_off_clusters(cuda, box):
    """A lone morphology whose gate is off: every CTA of its cluster keeps
    the inputs (K5: x_orig; K6: x and the three moments)."""
    (w, keep, n_iter, m, g, m1, v, vh, bm, thr, ds,
     gate) = _wide_inputs(cuda, 1, 1, box, 1, 5)
    gate = torch.zeros_like(gate)
    stepped = (m + g) * bm
    idx = kn.candidate_index(stepped, 1)
    assert torch.equal(kn.prox_chain(m + 1, stepped, idx, w, keep, thr,
                                     gate, n_iter), m + 1)
    opt = engine.AdaproxState(m1, v, vh)
    x, o = kn.fused_morph_update(m, g, opt, gate, w, keep, bm, thr, ds,
                                 n_iter)
    for a, b in zip((x, *o), (m, m1, v, vh)):
        assert torch.equal(a, b)


def _bucket(B, K, C=5, H=58, W=48, hb=BOX, wb=None, pad=61, seed=1):
    """Seeded components whose boxes reach up to pad - 1 pixels past
    every scene edge; blend 1 has no active component, and one active box
    of blend 0 lies wholly off the scene (pad > hb, wb)."""
    wb = hb if wb is None else wb
    rng = np.random.default_rng(seed)
    seds = rng.uniform(0.1, 2, (B, K, C)).astype(np.float32)
    morphs = rng.uniform(0, 1, (B, K, hb, wb)).astype(np.float32)
    oy = rng.integers(1 - pad, H - hb + pad, (B, K, 1))
    ox = rng.integers(1 - pad, W - wb + pad, (B, K, 1))
    origins = np.concatenate([oy, ox], -1).astype(np.int32)
    on = rng.uniform(size=(B, K)) > 0.2
    on[0, 0] = True
    on[1] = False
    origins[0, 0] = (H + 1, -wb - 1)
    assert origins.min() < 0
    return [torch.from_numpy(x) for x in (seds, morphs, origins, on)]


def _gradient(B, C, H, W, layout, device, seed=3):
    """A (B, C, H, W) gradient: contiguous, or the centered crop of a
    larger array (the engine's inverse FFT), read through its strides."""
    g = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        return torch.randn(B, C, H, W, generator=g).to(device)
    full = torch.randn(B, C, H + 31, W + 27, generator=g).to(device)
    return full[..., 15:15 + H, 13:13 + W]


# (box, C, K, scene): boxes 21-69 and a non-square one, C 1-8, K 1-40, the
# fit's 58 x 48 scene (K4's staged route up to 7 bands) and 160 x 160
# (above the staging budget at C > 1: the tiled route)
SCENE_GRAD_CASES = [
    (21, 5, 16, (58, 48)), (41, 5, 16, (58, 48)), (59, 5, 16, (58, 48)),
    (69, 5, 16, (58, 48)), (59, 1, 16, (58, 48)), (59, 8, 16, (58, 48)),
    (59, 5, 1, (58, 48)), (59, 5, 40, (58, 48)), ((31, 21), 3, 16, (57, 47)),
    (21, 5, 16, (160, 160)), (59, 1, 40, (160, 160)),
    (69, 8, 40, (160, 160))]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("box,C,K,scene", SCENE_GRAD_CASES)
def test_scene_and_grad_match_plain(cuda, box, C, K, scene, layout):
    """K3 bit for bit; K4 on the unpadded gradient (pad 0) and on the
    gradient padded by P, each on the route of its shape (the cases take
    both routes, kernels.grad_geometry): g_morph bit for bit, g_sed within
    1e-5 of sum |g * morph| and the same bits in two launches."""
    H, W = scene
    hb, wb = (box, box) if isinstance(box, int) else box
    P = max(hb, wb) + 2
    B = 4
    seds, morphs, origins, on = (x.to(cuda) for x in _bucket(
        B, K, C, H, W, hb, wb, P, seed=hb + C + K))
    before = kn.scene_assembly.launches
    got = kn.scene_assembly(seds, morphs, origins, on, (C, H, W), P)
    assert kn.scene_assembly.launches == before + 1
    assert torch.equal(got, kn.scene_assembly_plain(seds, morphs, origins,
                                                    on, (C, H, W), P))
    assert not got[1].any()
    grad = _gradient(B, C, H, W, layout, cuda)
    gpad = F.pad(grad, (P, P, P, P))
    for g, p in ((grad, 0), (gpad, P)):
        gs, gm = kn.grad_gather(g, seds, morphs, origins, p)
        rs, rm = kn.grad_gather_plain(g, seds, morphs, origins, p)
        assert torch.equal(gm, rm)
        # g_sed: a block reduction, in another order than torch's sum
        scale = kn.grad_gather_plain(g.abs(), seds, morphs, origins, p)[0]
        assert bool(((gs - rs).abs() <= 1e-5 * scale).all())
        again = kn.grad_gather(g, seds, morphs, origins, p)
        assert torch.equal(again[0], gs) and torch.equal(again[1], gm)


# (box, C, K, scene): more than 8 bands (K3's grouped instantiation, K4's
# tiled route), on the fit's 58 x 48 scene and on small scenes (40 x 40 at
# C = 12 and 16, 24 x 24 at C = 40, one tile each), unpadded and padded
MANY_BAND_CASES = [
    (59, 9, 16, (58, 48)), (59, 10, 16, (58, 48)), (21, 12, 16, (40, 40)),
    (21, 16, 16, (40, 40)), (21, 40, 16, (24, 24))]


@pytest.mark.cuda
@pytest.mark.parametrize("box,C,K,scene", MANY_BAND_CASES)
def test_scene_and_grad_match_plain_at_many_bands(cuda, box, C, K, scene):
    """K3 and K4 past 8 bands, one launch per call: K3 and g_morph bit for
    bit, g_sed within 1e-5 of sum |g * morph| and the same bits in two
    launches, on the unpadded (strided) gradient and padded by P; past 8
    bands K4 takes its tiled route at every shape."""
    H, W = scene
    P = box + 2
    B = 4
    seds, morphs, origins, on = (x.to(cuda) for x in _bucket(
        B, K, C, H, W, box, box, P, seed=box + C + K))
    kn.reset_launch_counts()
    got = kn.scene_assembly(seds, morphs, origins, on, (C, H, W), P)
    assert kn.launch_counts()["scene_assembly"] == 1
    assert torch.equal(got, kn.scene_assembly_plain(seds, morphs, origins,
                                                    on, (C, H, W), P))
    grad = _gradient(B, C, H, W, "strided", cuda)
    routes = []
    for g, p in ((grad, 0), (F.pad(grad, (P, P, P, P)), P)):
        routes.append(kn.grad_geometry(B, K, C, *g.shape[-2:], box,
                                       box).staged)
        before = kn.grad_gather.launches
        gs, gm = kn.grad_gather(g, seds, morphs, origins, p)
        assert kn.grad_gather.launches == before + 1
        rs, rm = kn.grad_gather_plain(g, seds, morphs, origins, p)
        assert torch.equal(gm, rm)
        scale = kn.grad_gather_plain(g.abs(), seds, morphs, origins, p)[0]
        assert bool(((gs - rs).abs() <= 1e-5 * scale).all())
        again = kn.grad_gather(g, seds, morphs, origins, p)
        assert torch.equal(again[0], gs) and torch.equal(again[1], gm)
    assert routes == [False, False]


# (box, C, K, scene, B): K4's tiled route at the lite fit's scene past 7
# bands (PAUS's 40 the most; 16 components, one warp a component, and 4,
# two warps), 5 bands at boxes 81 and 101 on scenes of their size, boxes
# past 170 (one, two and four components: 8, 4 and 4 warps a component),
# and band groups that do not fill their instantiation (20 bands; 70 in a
# group of 64 and one of 6)
TILED_CASES = [
    (59, 8, 16, (58, 48), 4), (59, 9, 16, (58, 48), 4),
    (59, 10, 16, (58, 48), 4), (59, 16, 16, (58, 48), 4),
    (59, 10, 4, (58, 48), 4),
    (59, 40, 16, (58, 48), 4), (81, 5, 16, (80, 80), 4),
    (101, 5, 16, (100, 100), 2), (171, 5, 4, (170, 170), 2),
    (201, 5, 2, (200, 200), 2), (256, 5, 1, (256, 256), 2),
    (21, 20, 8, (40, 40), 2), (21, 70, 5, (24, 24), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("box,C,K,scene,B", TILED_CASES, ids=str)
def test_tiled_route_matches_plain(cuda, box, C, K, scene, B):
    """K4's tiled route on the strided gradient (pad 0, as the fit calls
    it), contiguous, and padded by P, its boxes overhanging every edge
    (negative origins) and one wholly off the scene: one launch a call,
    g_morph bit for bit, g_sed within 1e-5 of sum |g * morph|, two
    launches the same bits."""
    H, W = scene
    P = box // 2 + 2
    seds, morphs, origins, _ = (x.to(cuda) for x in _bucket(
        B, K, C, H, W, box, box, P, seed=box + C + K))
    grad = _gradient(B, C, H, W, "strided", cuda)
    for g, p in ((grad, 0), (grad.contiguous(), 0),
                 (F.pad(grad, (P, P, P, P)), P)):
        assert kn.grad_geometry(B, K, C, *g.shape[-2:], box,
                                box).route == "tiled"
        before = kn.grad_gather.launches
        gs, gm = kn.grad_gather(g, seds, morphs, origins, p)
        assert kn.grad_gather.launches == before + 1
        rs, rm = kn.grad_gather_plain(g, seds, morphs, origins, p)
        assert torch.equal(gm, rm)
        scale = kn.grad_gather_plain(g.abs(), seds, morphs, origins, p)[0]
        assert bool(((gs - rs).abs() <= 1e-5 * scale).all())
        again = kn.grad_gather(g, seds, morphs, origins, p)
        assert torch.equal(again[0], gs) and torch.equal(again[1], gm)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [5, 10, 16])
def test_grad_gather_does_not_depend_on_the_batch(cuda, C):
    """A blend's g_sed and g_morph are the same bits alone and inside a
    larger batch, though the batch size sets the launch: on the staged
    route (5 bands) the components per block (G), whose warp map follows
    the component's index, not its place in the block; on the tiled route
    (10, 16) the tile rows and blocks an SM, while each warp keeps one
    component's sums in its registers across the tiles."""
    B, K = 128, 16
    whole_geo = kn.grad_geometry(B, K, C, 58, 48, BOX, BOX)
    part_geo = kn.grad_geometry(B // 4, K, C, 58, 48, BOX, BOX)
    assert whole_geo.route == ("staged" if C <= 7 else "tiled")
    if whole_geo.staged:
        assert whole_geo.G != part_geo.G
    else:
        assert (whole_geo.tile_rows, whole_geo.blocks_per_sm) != \
            (part_geo.tile_rows, part_geo.blocks_per_sm)
    seds, morphs, origins, _ = (x.to(cuda) for x in _bucket(B, K, C))
    grad = _gradient(B, C, 58, 48, "strided", cuda)
    whole = kn.grad_gather(grad, seds, morphs, origins, 0)
    part = kn.grad_gather(grad[:B // 4], seds[:B // 4], morphs[:B // 4],
                          origins[:B // 4], 0)
    assert torch.equal(part[0], whole[0][:B // 4])
    assert torch.equal(part[1], whole[1][:B // 4])


@pytest.mark.cuda
def test_gather_kernels_raise_past_shared_memory(cuda):
    """What is left of a limit: K3's origins and seds must fit a block's
    shared memory, and K4 one row of one band of the gradient, twice, with
    a row of each window; past it each wrapper raises ValueError naming
    the bytes, before any launch.  K4 takes box 171 (the limit of its
    earlier design) and matches its plain version."""
    kn.reset_launch_counts()
    C = 30000
    seds = torch.ones(1, 2, C, device=cuda)
    morphs = torch.ones(1, 2, 3, 3, device=cuda)
    origins = torch.zeros(1, 2, 2, dtype=torch.int32, device=cuda)
    on = torch.ones(1, 2, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="B of shared memory"):
        kn.scene_assembly(seds, morphs, origins, on, (C, 4, 4), 3)
    with pytest.raises(ValueError, match="B of shared memory"):
        kn.grad_gather(torch.ones(1, 1, 1, 30000, device=cuda),
                       torch.ones(1, 1, 1, device=cuda),
                       torch.ones(1, 1, 1, 1, device=cuda),
                       origins[:, :1], 0)
    counts = kn.launch_counts()
    assert counts["scene_assembly"] == counts["grad_gather"] == 0
    big = torch.rand(1, 1, 171, 171, device=cuda)
    grad = torch.randn(1, 1, 8, 8, device=cuda)
    sed = torch.ones(1, 1, 1, device=cuda)
    org = torch.full((1, 1, 2), -80, dtype=torch.int32, device=cuda)
    gs, gm = kn.grad_gather(grad, sed, big, org, 0)
    rs, rm = kn.grad_gather_plain(grad, sed, big, org, 0)
    assert torch.equal(gm, rm)
    assert bool(((gs - rs).abs() <= 1e-5 * kn.grad_gather_plain(
        grad.abs(), sed, big, org, 0)[0]).all())
    assert kn.launch_counts()["grad_gather"] == 1


@pytest.mark.cuda
def test_scene_skips_inactive_slots(cuda):
    """The stated difference (csrc/scene.cu): the kernel ignores an
    inactive slot even where its morphology is NaN; the plain version's
    parked box then turns pixels NaN."""
    P = 61
    seds, morphs, origins, on = (x.to(cuda) for x in _bucket(3, 8, pad=P))
    morphs[0, ~on[0]] = float("nan")
    keep = on[0].nonzero()[:, 0]
    got = kn.scene_assembly(seds, morphs, origins, on, (5, 58, 48), P)
    ref = kn.scene_assembly_plain(seds[:1, keep], morphs[:1, keep],
                                  origins[:1, keep], on[:1, keep],
                                  (5, 58, 48), P)
    assert torch.equal(got[:1], ref)


@pytest.mark.cuda
def test_kernel_info_leaves_launches_valid(cuda):
    """Querying the compiler facts at small shapes does not shrink a
    kernel's shared-memory allowance: launches at larger shapes (more
    components, the staged gradient) still run."""
    kn.gather_kernel_info(2, 1, 5, 58, 48, 21, 21)
    kn.mono_kernel_info(21, 21)
    seds, morphs, origins, on = (x.to(cuda) for x in _bucket(2, 16))
    got = kn.scene_assembly(seds, morphs, origins, on, (5, 58, 48), 61)
    assert torch.equal(got, kn.scene_assembly_plain(
        seds, morphs, origins, on, (5, 58, 48), 61))
    grad = _gradient(2, 5, 58, 48, "strided", cuda)
    assert kn.grad_geometry(2, 16, 5, 58, 48, BOX, BOX).staged
    gm = kn.grad_gather(grad, seds, morphs, origins, 0)[1]
    assert torch.equal(gm, kn.grad_gather_plain(grad, seds, morphs,
                                                origins, 0)[1])
    w, keep, n_iter = (x.to(cuda) if torch.is_tensor(x) else x
                       for x in _tables())
    m, idx = (x.to(cuda) for x in _morphs(2, 4))
    assert torch.equal(kn.monotonic_prox(m, idx, w, keep, n_iter),
                       kn.monotonic_prox_plain(m, idx, w, keep, n_iter))


@pytest.mark.cuda
def test_wrappers_reject_bad_input(cuda):
    w, keep, n_iter = _tables(21)
    m = torch.rand(3, 21, 21, device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    wt, kt = w.to(cuda), keep.to(cuda)
    with pytest.raises(TypeError):
        kn.monotonic_prox(m.double(), idx, wt.double(), kt.double(), n_iter)
    with pytest.raises(ValueError):
        kn.monotonic_prox(m.transpose(-2, -1), idx, wt, kt, n_iter)
    with pytest.raises(ValueError):
        kn.monotonic_prox(m, idx, wt.cpu(), kt, n_iter)


@pytest.mark.cuda
def test_fit_on_card_matches_cpu(cuda):
    # a well-conditioned blend: a 1e-7 relative change of its images moves
    # the logL of a 30-iteration CPU fit by < 1e-6.  Some generated blends
    # are not (seed 3: 3e-2 within 3 iterations, through the discrete
    # threshold and center-pick decisions of the prox), and there card and
    # CPU part by as much as two CPU runs on perturbed inputs do.
    d = generate_blend(np.random.default_rng(1))

    def blend():
        weights = (1.0 / d["variance"]).astype(np.float32)
        mpsf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
            np.float32)
        obs = lite.LiteObservation(d["images"], d["variance"], weights,
                                   d["psfs"], model_psf=mpsf)
        centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
                   for r in d["catalog"]]
        src = lite.parameterize_sources(
            lite.init_all_sources_main(obs, centers), obs,
            lite.init_adaprox_component)
        return lite.LiteBlend(src, obs)

    # e_rel=0 runs all 30 iterations, so the histories compare one to one
    cpu, card = blend(), blend()
    kn.reset_launch_counts()
    card.fit(30, e_rel=0.0, device=cuda)
    counts = kn.launch_counts()
    # the default configuration's kernels (K5 and K6 run only in the
    # packed_prox_chain and fuse_morph configurations)
    assert all(counts[name] > 0 for name in
               ("monotonic_prox", "scene_assembly", "grad_gather"))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    cpu.fit(30, e_rel=0.0)
    assert len(card.loss) == len(cpu.loss) == 30
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-4)


# the T1 variant that may differ from its plain version, as a share of the
# plain result's largest value: alu8's fused multiply-add rounds once where
# the plain version rounds twice (the multiply by 0.5 is exact, so they
# agree barring subnormals).  bf16's plain version rounds each operation
# once to bf16, as the bf16x2 instructions do: bit for bit
T1_BOUNDS = {"alu8": 1e-6}


@pytest.mark.cuda
@pytest.mark.parametrize("mix", kn.MONO_PASS_MIXES)
def test_mono_pass_variant_matches_plain(cuda, mix):
    from scarlet_tpu_torch.tools import mono_pass_attrib as tool

    wsel, keepsel, _, _ = (torch.from_numpy(a).to(cuda)
                           for a in tool.slot_tables())
    packed = torch.from_numpy(tool.packed_input()).to(cuda)
    before = kn.mono_pass_variant.launches
    got = kn.mono_pass_variant(packed, wsel, keepsel, mix, 8)
    assert kn.mono_pass_variant.launches == before + 1
    ref = kn.mono_pass_variant_plain(packed, wsel, keepsel, mix, 8)
    err = float((got - ref).abs().max())
    assert err <= T1_BOUNDS.get(mix, 0.0) * float(ref.abs().max()), err


@pytest.mark.cuda
def test_mono_pass_full_equals_production(cuda):
    """``full`` at 16 forced passes equals K1 at n_iter=16, tol=0 bit for
    bit: K1 stops only after a block that changed nothing."""
    from scarlet_tpu_torch.tools import mono_pass_attrib as tool

    wsel, keepsel, wtab, keep = (torch.from_numpy(a).to(cuda)
                                 for a in tool.slot_tables())
    packed = torch.from_numpy(tool.packed_input(4)).to(cuda)
    idx = torch.zeros((4, tool.K), dtype=torch.int32, device=cuda)
    ref = kn.monotonic_prox_packed(packed, idx, wtab, keep, tool.S, 16,
                                   tol=0.0)
    assert torch.equal(kn.mono_pass_variant(packed, wsel, keepsel, "full",
                                            16), ref)


@pytest.mark.cuda
def test_detection_on_card_matches_cpu(cuda):
    """detect_peaks_device on the card and on the CPU, 4 generated blends:
    the same catalogs (the support's sums accumulate in float64, so both
    devices take the same threshold decisions)."""
    from scarlet_tpu_torch.parallel import detect_peaks_device

    rng = np.random.default_rng(3)
    blends = [generate_blend(rng) for _ in range(4)]
    images = torch.from_numpy(np.stack([b["images"] for b in blends]))
    variance = torch.from_numpy(np.stack([b["variance"] for b in blends]))
    cpu = detect_peaks_device(images, variance, max_peaks=24)
    card = detect_peaks_device(images.to(cuda), variance.to(cuda),
                               max_peaks=24)
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)
    assert bool(cpu[1].any(dim=1).all())


@pytest.mark.cuda
def test_mask_closure_on_card_matches_cpu(cuda):
    """monotonic_mask_device on a (3 * 128 * 16, 59, 59) batch, the
    wavelet stream's chunk of three dictionaries: the card's masks and
    models equal the CPU's bit for bit."""
    from scarlet_tpu_torch.ops.prox import monotonic_mask_device

    m, _ = _morphs(3 * 128, 16, seed=5)
    x = m - 0.4                      # negative pixels stop the closure
    centers = torch.full((3 * 128, 16, 2), BOX // 2, dtype=torch.long)
    cpu = monotonic_mask_device(x, centers)
    card = monotonic_mask_device(x.to(cuda), centers.to(cuda))
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)
    assert 1 < int(cpu[0].sum(dim=(-2, -1)).min())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(recipe="wavelets"), dict(use_mask=True)],
                         ids=["wavelets", "mask"])
def test_stream_setup_on_card_matches_cpu(cuda, kw):
    """stream_setup on 4 generated blends (seeds 0, 1, 2, 4), on the card
    and on the CPU: the same discrete init decisions, seeds to 1e-4."""
    from scarlet_tpu_torch.parallel import stream

    blends = [generate_blend(np.random.default_rng(s)) for s in (0, 1, 2, 4)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((4, K, 2), np.int32)
    active = np.zeros((4, K), bool)
    for i, b in enumerate(blends):
        k = len(b["catalog"])
        centers[i, :k] = np.round(np.stack([b["catalog"]["y"],
                                            b["catalog"]["x"]], -1))
        active[i, :k] = True
    args = [np.stack([b[k] for b in blends])
            for k in ("images", "variance", "psfs")]
    mp = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    out = [stream.stream_setup(*args, centers, mp, center_active=active,
                               box_size=BOX, n_slots=16, device=dev, **kw)
           for dev in (cuda, "cpu")]
    (_, dc, sc, ac), (_, dp, sp, ap) = out
    for k in ("n_active", "overflow", "slot_source", "split",
              "psf_fallback"):
        assert torch.equal(ac[k].cpu(), ap[k]), k
    for f in ("origins", "comp_active"):
        assert torch.equal(getattr(sc, f)[0].cpu(), getattr(sp, f)[0]), f
    assert torch.equal(dc.box_masks[0].cpu(), dp.box_masks[0])
    for f in ("seds", "morphs"):
        torch.testing.assert_close(getattr(sc, f)[0].cpu(),
                                   getattr(sp, f)[0], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("box", [21, 59])
def test_monotonic_prox_tensor_tol_matches_plain(cuda, box):
    """K1 and K2 with one exit tolerance per blend, read on the card,
    mixing 0, 1e-3 and 1e6, bit for bit against the plain version; a
    tensor filled with the static tolerance gives the float launch's
    bits."""
    w, keep, n_iter = _tables(box)
    m, idx = _morphs(4, 16, box)
    args = [x.to(cuda) for x in (m, idx, w, keep)]
    tols = torch.tensor([0.0, 1e-3, 1e6, 1e-3], device=cuda)
    before = kn.launch_counts()
    got = kn.monotonic_prox(*args, n_iter, tol=tols)
    after = kn.launch_counts()
    assert after["monotonic_prox"] == before["monotonic_prox"] + 1
    assert after["monotonic_prox_tol_tensor"] == \
        before["monotonic_prox_tol_tensor"] + 1
    assert torch.equal(got, kn.monotonic_prox_plain(*args, n_iter, tol=tols))
    packed = args[0].transpose(-3, -2).reshape(4, box, 16 * box).contiguous()
    got_p = kn.monotonic_prox_packed(packed, *args[1:], box, n_iter,
                                     tol=tols)
    assert torch.equal(got_p.reshape(4, box, 16, box).transpose(-3, -2),
                       got)
    for tol in (0.0, 1e-3):
        assert torch.equal(
            kn.monotonic_prox(*args, n_iter, tol=torch.full((4,), tol,
                                                            device=cuda)),
            kn.monotonic_prox(*args, n_iter, tol=tol))
    with pytest.raises(ValueError, match="on mixed devices|tensors on"):
        kn.monotonic_prox(*args, n_iter, tol=tols.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("nw", ["angle", "flat"])
@pytest.mark.parametrize("shape", [(1, 1, 81, 81), (1, 1, 101, 101),
                                   (2, 3, 77, 130), (1, 2, 150, 150),
                                   (1, 1, 540, 540)])
def test_monotonic_prox_wide_matches_plain(cuda, shape, nw):
    """K1 on boxes beyond ``mono_geometry`` (more than 73 pixels a side:
    the object tree's grown boxes and whole-frame seeds) runs the wide
    engine's ``mono_kernel_wide``, its bands' planes in the cluster's
    shared memory (81, 101, 77 x 130, 150) or, past what 16 CTAs hold, in
    a device-memory workspace (540), bit for bit against the plain
    version: tol 0 at min_gradient 0 and 0.1, tol 1e-3, one tolerance
    per blend, the packed layout (K2) and the 9-candidate table."""
    B, K, hb, wb = shape
    with pytest.raises(ValueError):
        kn.mono_geometry(hb, wb)
    assert kn.mono_wide_workspace(hb, wb) == (hb == 540)
    w, keep, n_iter = engine.monotonicity_tables((hb, wb), 1, nw)
    w = torch.from_numpy(w.astype(np.float32)).to(cuda)
    keep = torch.from_numpy(keep.astype(np.float32)).to(cuda)
    rng = np.random.default_rng(hb)
    yy, xx = np.mgrid[:hb, :wb]
    prof = np.exp(-((yy - hb // 2) ** 2 + (xx - wb // 2) ** 2)
                  / (2 * (min(hb, wb) / 5) ** 2))
    m = torch.from_numpy((prof + 0.1 * rng.normal(size=shape))
                         .astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 9, (B, K))).to(cuda)
    tols = torch.tensor([0.0, 1e-3][:B], device=cuda)
    for kw in (dict(), dict(min_gradient=0.1), dict(tol=1e-3),
               dict(tol=tols)):
        before = kn.launch_counts()
        got = kn.monotonic_prox(m, idx, w, keep, n_iter, **kw)
        after = kn.launch_counts()
        assert after["monotonic_prox_wide"] == \
            before["monotonic_prox_wide"] + 1
        assert torch.equal(got, kn.monotonic_prox_plain(m, idx, w, keep,
                                                        n_iter, **kw))
    packed = m.transpose(-3, -2).reshape(B, hb, K * wb).contiguous()
    got_p = kn.monotonic_prox_packed(packed, idx, w, keep, wb, n_iter)
    assert torch.equal(got_p.reshape(B, hb, K, wb).transpose(-3, -2),
                       kn.monotonic_prox(m, idx, w, keep, n_iter))


@pytest.mark.cuda
def test_object_tree_box_grows_past_73_on_card(cuda):
    """``Blend.fit`` on the card with a box that grows past 73 pixels
    (``testing.large_galaxy_fit``: 71 -> 81): the projection runs the
    wide engine's ``mono_kernel_wide`` from the growth on, the boxes
    after each 10 iterations equal the CPU's, and the losses agree to
    1e-4."""
    from scarlet_tpu_torch.testing import large_galaxy_fit

    kn.reset_launch_counts()
    card, boxes = large_galaxy_fit(cuda)
    assert kn.launch_counts()["monotonic_prox_wide"] > 0
    cpu, cpu_boxes = large_galaxy_fit("cpu")
    assert boxes == cpu_boxes and max(boxes[-1]) > 73
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-4)


@pytest.mark.cuda
def test_lite_fit_at_box_181_on_card(cuda):
    """A lite fit past box 170 on the card: the large galaxy (3 bands,
    180 x 180) and a second source, the port's own init, one bucket forced
    to box 181 (the cap max(H, W) + 1), 10 iterations through the engine.
    K4 runs its tiled route once an iteration; the losses are finite,
    improve, and are held to the CPU's at rtol 1e-4
    (``testing.fit_gaps``) with every convolution in float64 on both
    devices, and with the card's convolutions run on the CPU.  cuFFT's
    float32 fit is not held to the CPU's: the first SED gradient of this
    fit cancels to ~3e-6 of its terms, so one float32 rounding of the
    model's scale turns its sign and the fit's path (ROADMAP.md Queue 3,
    F4; tests/test_torch_parity.py)."""
    from scarlet_tpu_torch.testing import fit_gaps, large_galaxy_engine

    config, data, state = large_galaxy_engine(cuda)
    assert config.box_shapes == ((181, 181),)
    assert kn.grad_geometry(1, config.bucket_counts[0], *config.scene_shape,
                            181, 181).route == "tiled"
    kn.reset_launch_counts()
    _, loss = engine.fit_scan(state, data, config, 10)
    assert kn.launch_counts()["grad_gather"] == 10
    loss = loss.cpu().numpy()
    assert np.isfinite(loss).all() and loss[-1] > loss[0]
    gaps = fit_gaps(cuda, loss)
    assert gaps["host_convolutions"] <= 1e-4 and gaps["exact"] <= 1e-4, \
        gaps


@pytest.mark.cuda
def test_dft_matches_fft_on_card(cuda):
    """The matmul-DFT convolution on the card against cuFFT and against a
    float64 reference: within 1e-5 of the largest output (a TF32 product
    keeps ~3 digits and would be off by ~1e-3)."""
    from scarlet_tpu_torch.ops import fft

    engine.pin_float32(cuda)
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.normal(size=(8, 5, 58, 48)).astype(
        np.float32))
    kern = torch.from_numpy(rng.normal(size=(5, 21, 21)).astype(np.float32))
    shape = fft.minimal_same_fft_shape((5, 58, 48), tuple(kern.shape),
                                       axes=(1, 2))
    ref64 = fft.convolve_fft(img.double(), fft.transform(kern.double(),
                                                         shape), shape)
    kr = fft.transform(kern, shape).to(cuda)
    ops = fft.dft_conv_operators((58, 48), shape, torch.float32, cuda)
    got = fft.convolve_dft(img.to(cuda), kr, ops).cpu()
    assert got.is_contiguous()
    viafft = fft.convolve_fft(img.to(cuda), kr, shape).cpu()
    scale = float(ref64.abs().max())
    assert float((got.double() - ref64).abs().max()) <= 1e-5 * scale
    assert float((got - viafft).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_fit_options_on_card_match_cpu(cuda):
    """Chunk of 4 generated blends (seeds 0, 1, 2, 4) with box growth and
    the scheduled tolerance, fitted with the card's config on the card and
    on the CPU (plain versions at the same tolerances): the same grown
    boxes and iterations, logL rtol 1e-4; the DFT convolution as well."""
    from scarlet_tpu_torch.parallel import batch, stream

    blends = [generate_blend(np.random.default_rng(s)) for s in (0, 1, 2, 4)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((4, K, 2), np.int32)
    active = np.zeros((4, K), bool)
    for i, b in enumerate(blends):
        k = len(b["catalog"])
        centers[i, :k] = np.round(np.stack([b["catalog"]["y"],
                                            b["catalog"]["x"]], -1))
        active[i, :k] = True
    args = [np.stack([b[k] for b in blends])
            for k in ("images", "variance", "psfs")]
    mp = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    kw = dict(center_active=active, box_size=BOX, n_slots=16, box_grow=0.1,
              mono_tol_early=1e-2, mono_tol_switch=10, e_rel=0.0)
    cfg, dc, sc, _ = stream.stream_setup(*args, centers, mp, device=cuda,
                                         **kw)
    _, dp, sp, _ = stream.stream_setup(*args, centers, mp, device="cpu",
                                       mono_tol=cfg.mono_tol, **kw)
    for conf in (cfg, dataclasses.replace(cfg, conv_mode="dft")):
        kn.reset_launch_counts()
        oc, _ = batch.fit_batch_device_converged(sc, dc, conf, 30, 10)
        assert kn.launch_counts()["monotonic_prox_tol_tensor"] > 0
        op, _ = batch.fit_batch_device_converged(sp, dp, conf, 30, 10)
        assert torch.equal(oc.box_half[0].cpu(), op.box_half[0])
        assert torch.equal(oc.it.cpu(), op.it)
        np.testing.assert_allclose(oc.last_loss.cpu().numpy(),
                                   op.last_loss.numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_fista_and_real_mode_on_card_match_cpu(cuda):
    """A FISTA ``LiteBlend`` (seed 1) fitted 20 iterations on the card and
    on the CPU: logL rtol 1e-4; the real-space convolution mode on the
    card against the CPU's, within 1e-5 of its largest value (cuDNN
    without TF32)."""
    d = generate_blend(np.random.default_rng(1))

    def blend(dev, mode="fft"):
        weights = (1.0 / d["variance"]).astype(np.float32)
        mpsf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
            np.float32)
        obs = lite.LiteObservation(d["images"], d["variance"], weights,
                                   d["psfs"], model_psf=mpsf, device=dev,
                                   convolution_mode=mode)
        centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
                   for r in d["catalog"]]
        src = lite.parameterize_sources(
            lite.init_all_sources_main(obs, centers), obs,
            lite.init_fista_component)
        return lite.LiteBlend(src, obs)

    card, cpu = blend(cuda), blend("cpu")
    card.fit(20, e_rel=0.0, resize=None, reweight=False)
    cpu.fit(20, e_rel=0.0, resize=None, reweight=False)
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-4)
    oc, op = blend(cuda, "real").observation, blend("cpu", "real").observation
    img = torch.from_numpy(np.random.default_rng(2).normal(
        size=oc.shape).astype(np.float32))
    ref = op.convolve(img)
    got = oc.convolve(img.to(cuda)).cpu()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# The multi-resolution fit (K1, K3 and K4 through parallel.multires)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_band_limit_matches_the_kernels(cuda):
    """The gather kernels have no band limit: at 9 bands, one past their
    one-group instantiations, both wrappers launch once and equal their
    plain versions (K3 and g_morph bit for bit, g_sed within 1e-5 of
    sum |g * morph|)."""
    C = 9
    seds, morphs, origins, on = (x.to(cuda) for x in _bucket(2, 4, C=C))
    kn.reset_launch_counts()
    got = kn.scene_assembly(seds, morphs, origins, on, (C, 58, 48), 61)
    assert torch.equal(got, kn.scene_assembly_plain(
        seds, morphs, origins, on, (C, 58, 48), 61))
    grad = _gradient(2, C, 58, 48, "strided", cuda)
    gs, gm = kn.grad_gather(grad, seds, morphs, origins, 0)
    rs, rm = kn.grad_gather_plain(grad, seds, morphs, origins, 0)
    assert torch.equal(gm, rm)
    scale = kn.grad_gather_plain(grad.abs(), seds, morphs, origins, 0)[0]
    assert bool(((gs - rs).abs() <= 1e-5 * scale).all())
    counts = kn.launch_counts()
    assert counts["scene_assembly"] == counts["grad_gather"] == 1


@pytest.mark.cuda
def test_assemble_scene_on_card_matches_cpu(cuda):
    """The scene Function at the smoke's shapes (64 blends, 3 slots, box
    31, a (2, 84, 84) frame), one slot off: forward bit for bit, seds' and
    morphologies' gradients against the CPU's plain versions (g_morph bit
    for bit, g_sed within 1e-5 of sum |g * morph|), each once per launch."""
    from scarlet_tpu_torch.parallel import multires

    B, K, C, S, H = 64, 3, 2, 31, 84
    rng = np.random.default_rng(5)
    seds = torch.from_numpy(rng.uniform(0.1, 2, (B, K, C)).astype(
        np.float32))
    morphs = torch.from_numpy(rng.uniform(0, 1, (B, K, S, S)).astype(
        np.float32))
    origins = torch.from_numpy(rng.integers(0, H - S + 1, (B, K, 2)).astype(
        np.int32))
    active = torch.ones(B, K, dtype=torch.bool)
    active[3, 1] = False
    G = torch.randn(B, C, H, H, generator=torch.Generator().manual_seed(6))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        s = seds.to(dev).requires_grad_()
        m = morphs.to(dev).requires_grad_()
        kn.reset_launch_counts()
        scene = multires.assemble_scene(s, m, origins.to(dev),
                                        active.to(dev), (C, H, H))
        (scene * G.to(dev)).sum().backward()
        counts = kn.launch_counts()
        out[dev.type] = [t.detach().cpu() for t in (scene, s.grad, m.grad)]
        if dev.type == "cuda":
            assert counts["scene_assembly"] == counts["grad_gather"] == 1
    card, cpu = out["cuda"], out["cpu"]
    assert torch.equal(card[0], cpu[0])
    assert torch.equal(card[2], cpu[2])
    scale = kn.grad_gather_plain(G.abs(), seds, morphs, origins, 0)[0]
    assert bool(((card[1] - cpu[1]).abs() <= 1e-5 * scale).all())
    assert not card[1][3, 1].any() and not card[2][3, 1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rotation", [0.0, np.deg2rad(28)])
def test_multires_fit_on_card_matches_cpu(cuda, rotation):
    """10 iterations of the full-width pair (4 blends) on the card and the
    CPU: the loss histories within rtol 1e-4; K1, K3 and K4 launched."""
    from scarlet_tpu_torch import models
    from scarlet_tpu_torch.parallel import MultiResFitter, multires_init
    from scarlet_tpu_torch.testing import blob_centers, make_pair

    hist = {}
    for dev in (cuda, torch.device("cpu")):
        hr, lr, dh, dl = make_pair(rotation_lr=rotation, device=dev)
        frame = models.Frame.from_observations([lr, hr], obs_id=1)
        sc = np.asarray([1.0, 0.8, 1.2, 0.9], np.float32)[:, None, None,
                                                          None]
        datas = (dh[None, None] * sc, dl[None, None] * sc)
        weights = tuple(np.full_like(d, 400.0) for d in datas)
        init = multires_init((hr, lr), datas, blob_centers(frame, 4),
                             box_size=31, n_slots=3)
        kn.reset_launch_counts()
        fit = MultiResFitter((hr, lr), box_size=31)
        hist[dev.type] = fit.fit(datas, weights, *init, n_iter=10)[4].cpu()
        if dev.type == "cuda":
            counts = kn.launch_counts()
            assert all(counts[n] >= 10 for n in
                       ("monotonic_prox", "scene_assembly", "grad_gather"))
            assert not torch.backends.cuda.matmul.allow_tf32
    np.testing.assert_allclose(hist["cuda"].numpy(), hist["cpu"].numpy(),
                               rtol=1e-4)


@pytest.mark.cuda
def test_object_tree_quickstart_matches_the_cpu(cuda):
    """The quickstart recipe on the card: parameters in float32, the
    morphology projection through K1, init decisions equal to the CPU's,
    losses within 1e-4 from the init without the spectrum solve (the
    solve's least-squares start makes the float32 trajectory part at
    ~1e-3 on any roundoff change, in the JAX package too)."""
    from scarlet_tpu_torch import initialization, models

    d = generate_blend(np.random.default_rng(1), shape=(3, 40, 40),
                       n_sources=3)
    centers = [(float(r["y"]), float(r["x"])) for r in d["catalog"]]
    runs = {}
    for dev in ("cpu", "cuda"):
        frame = models.Frame(d["images"].shape, channels=list(d["filters"]),
                             psf=models.GaussianPSF(sigma=0.8, boxsize=15))
        obs = models.Observation(
            d["images"], list(d["filters"]), psf=models.ImagePSF(d["psfs"]),
            weights=(1 / d["variance"]).astype(np.float32),
            device=dev).match(frame)
        src, skipped = initialization.init_all_sources(
            frame, centers, obs, max_components=2, min_snr=30, silent=True,
            set_spectra=False)
        kn.reset_launch_counts()
        blend = models.Blend(src, obs)
        blend.fit(20, e_rel=0)
        runs[dev] = (blend, kn.launch_counts()["monotonic_prox"],
                     [(type(s).__name__, tuple(s.bbox.shape)) for s in src])
    assert runs["cuda"][1] > 0 and runs["cpu"][1] == 0
    assert runs["cuda"][2] == runs["cpu"][2]
    assert all(p.value.dtype == torch.float32 and p.value.is_cuda
               for p in runs["cuda"][0].parameters if not p.fixed)
    np.testing.assert_allclose(runs["cuda"][0].loss, runs["cpu"][0].loss,
                               rtol=1e-4)



@pytest.mark.cuda
@pytest.mark.parametrize("nw", ["angle", "flat"])
@pytest.mark.parametrize("shape, center", [((58, 48), (20, 31)),
                                           ((58, 48), (29, 24)),
                                           ((128, 128), (40, 90))])
def test_monotonic_prox_at_starlet_shapes_matches_plain(cuda, shape, center,
                                                        nw):
    """K1 at the starlet recipes' seed projections: one (1, 1, H, W)
    frame-sized image per source, projected about the source's pixel
    (``SingleExtendedSource.init_morph``): (58, 48) on ``mono_kernel``,
    (128, 128) on ``mono_kernel_wide``; bit for bit against the plain
    version."""
    from scarlet_tpu_torch.ops import prox

    H, W = shape
    rng = np.random.default_rng(H + center[0])
    yy, xx = np.mgrid[:H, :W]
    img = np.exp(-((yy - center[0]) ** 2 + (xx - center[1]) ** 2) / 40.0)
    m = torch.from_numpy((img + 0.05 * rng.normal(size=shape))
                         .astype(np.float32)).to(cuda)[None, None]
    wt, kt, depth, idx = prox.device_tables(shape, nw, [center], cuda,
                                            torch.float32)
    before = kn.launch_counts()
    got = kn.monotonic_prox(m, idx, wt, kt, depth, 0.0, tol=0.0)
    after = kn.launch_counts()
    assert after["monotonic_prox"] == before["monotonic_prox"] + 1
    assert (after["monotonic_prox_wide"] > before["monotonic_prox_wide"]) \
        == (H > 73)
    assert torch.equal(got, kn.monotonic_prox_plain(m, idx, wt, kt, depth,
                                                    0.0, tol=0.0))


@pytest.mark.cuda
def test_starlet_fit_on_card_matches_cpu(cuda):
    """The starlet_source recipe on the card (examples/starlet_source.py:
    a StarletSource and two SingleExtendedSources, 10 iterations): the
    coefficients in float32 on the card, the seeds' projections through
    K1, the same boxes as the CPU's, losses within 1e-4 of the CPU's."""
    from scarlet_tpu_torch import models

    d = generate_blend(np.random.default_rng(0), shape=(3, 40, 40),
                       n_sources=3)
    centers = [(float(r["y"]), float(r["x"])) for r in d["catalog"]]
    runs = {}
    for dev in ("cpu", "cuda"):
        frame = models.Frame(d["images"].shape, channels=list(d["filters"]),
                             psf=models.GaussianPSF(sigma=0.8, boxsize=15))
        obs = models.Observation(
            d["images"], list(d["filters"]), psf=models.ImagePSF(d["psfs"]),
            weights=(1 / d["variance"]).astype(np.float32),
            device=dev).match(frame)
        kn.reset_launch_counts()
        src = [models.StarletSource(frame, centers[0], obs,
                                    starlet_thresh=5e-3)]
        src += [models.SingleExtendedSource(frame, c, obs)
                for c in centers[1:]]
        blend = models.Blend(src, obs)
        blend.fit(10, e_rel=0)
        runs[dev] = (blend, kn.launch_counts()["monotonic_prox"],
                     [(type(s).__name__, tuple(s.bbox.shape),
                       tuple(s.bbox.origin)) for s in src])
    assert runs["cuda"][1] > 0 and runs["cpu"][1] == 0
    assert runs["cuda"][2] == runs["cpu"][2]
    coeffs = runs["cuda"][0].sources[0].parameters[1].value
    assert coeffs.dtype == torch.float32 and coeffs.is_cuda
    np.testing.assert_allclose(runs["cuda"][0].loss, runs["cpu"][0].loss,
                               rtol=1e-4)


def _card_batch(cuda, n=8, seed=4):
    """``n`` generated blends, host-initialized and packed on the card."""
    from scarlet_tpu_torch import parallel

    rng = np.random.default_rng(seed)
    mpsf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    blends = []
    for _ in range(n):
        d = generate_blend(rng)
        obs = lite.LiteObservation(
            d["images"], d["variance"],
            (1.0 / d["variance"]).astype(np.float32), d["psfs"],
            model_psf=mpsf, device="cpu")
        centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
                   for r in d["catalog"]]
        blends.append(lite.LiteBlend(lite.parameterize_sources(
            lite.init_all_sources_main(obs, centers), obs,
            lite.init_adaprox_component), obs))
    return parallel.pack_blends(blends, device=cuda)


def _one_rank_group(backend, tmp_path):
    import torch.distributed as dist

    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    return dist


@pytest.mark.cuda
def test_fit_batch_sharded_at_world_size_one_equals_fit_batch(cuda,
                                                              tmp_path):
    """``fit_batch_sharded`` on a one-rank NCCL mesh runs ``fit_batch``'s
    kernels on the same tensors and gathers them: the same bits."""
    from scarlet_tpu_torch import parallel

    config, data, state = _card_batch(cuda)
    ref, ref_losses = parallel.fit_batch(state, data, config, 10)
    dist = _one_rank_group("nccl", tmp_path)
    try:
        kn.reset_launch_counts()
        out, losses = parallel.fit_batch_sharded(
            state, data, config, 10, parallel.make_mesh())
        counts = kn.launch_counts()
    finally:
        dist.destroy_process_group()
    assert all(counts[name] > 0 for name in
               ("monotonic_prox", "scene_assembly", "grad_gather"))
    assert torch.equal(losses, ref_losses)
    leaves = [x for x, y in zip(_flat(out), _flat(ref))
              if x.device == y.device and torch.equal(x, y)]
    assert len(leaves) == len(_flat(ref))


def _flat(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_band_axis_at_world_size_one_equals_unsharded(cuda, tmp_path,
                                                      backend):
    """The engine's band sums over a one-rank band group (gloo through a
    host copy of each CUDA tensor) leave the fit's bits as they are: the
    same fit as the unpacked branch, which the band axis takes."""
    from scarlet_tpu_torch import parallel

    config, data, state = _card_batch(cuda, n=4)
    plain = dataclasses.replace(config, packed_morphs=False,
                                fuse_morph=False)
    ref, ref_losses = parallel.fit_batch(state, data, plain, 10)
    banded = dataclasses.replace(config, band_axis="bands",
                                 n_bands_total=config.scene_shape[0])
    dist = _one_rank_group(backend, tmp_path)
    try:
        with engine.band_group("bands", dist.group.WORLD):
            out, losses = parallel.fit_batch(state, data, banded, 10)
    finally:
        dist.destroy_process_group()
    assert torch.equal(losses, ref_losses)
    for field in ("seds", "morphs"):
        for x, y in zip(getattr(out, field), getattr(ref, field)):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
def test_bf16_matmul_matches_plain(cuda, passes):
    """The bf16 tiers' product (``ops.fft.bf16_matmul``: bf16 tensor-core
    operands, float32 sums, a float32 result) against its plain version
    on the CPU, on the four products of a tier convolution at the host
    path's shapes: within 1e-6 of the largest value (the products are
    exact; only the order of the float32 sums differs).  A bf16 result
    would be off by ~4e-3."""
    from scarlet_tpu_torch.ops import fft

    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.normal(size=(8, 5, 58, 48)).astype(
        np.float32))
    shape = fft.minimal_same_fft_shape((5, 58, 48), (5, 21, 21), axes=(1, 2))
    precision = "default" if passes == 1 else "high"
    ops = fft.dft_conv_operators((58, 48), shape, torch.float32, "cpu",
                                 precision)
    ops_d = fft.dft_conv_operators((58, 48), shape, torch.float32, cuda,
                                   precision)
    Hf, Wh = ops.A.shape[-1] // 2, ops.B.shape[-1] // 2
    lefts = [img.reshape(-1, 48)] + [
        torch.from_numpy(rng.normal(size=(8 * 5 * Wh, n)).astype(
            np.float32)) for n in (2 * 58, 2 * Hf)] + [
        torch.from_numpy(rng.normal(size=(8 * 5 * 58, 2 * Wh)).astype(
            np.float32))]
    for a, b, b_d in zip(lefts, (ops.B, ops.A, ops.iA, ops.iB),
                         (ops_d.B, ops_d.A, ops_d.iA, ops_d.iB)):
        assert torch.equal(b_d.cpu(), b)
        ref = fft.bf16_matmul(a, b, passes)
        got = fft.bf16_matmul(a.to(cuda), b_d, passes)
        assert got.dtype == torch.float32
        scale = float(ref.abs().max())
        assert float((got.cpu() - ref).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_quantized_upload_matches_host_rounding(cuda, name):
    """A quantized upload (bulk: the pinned host stack; overlap: a
    chunk's slice) reaches the card as the host rounding's bits, and its
    cast back to float32 there equals the host's."""
    from scarlet_tpu_torch.parallel import stream

    rng = np.random.default_rng(7)
    x = (rng.normal(size=(16, 5, 58, 48)) * 100).astype(np.float32)
    q = stream._quant_dtype(name)
    host = torch.from_numpy(x).to(q)
    up = stream._upload(x, cuda, q)
    torch.cuda.synchronize()
    assert up.dtype == q and up.device.type == "cuda"
    assert torch.equal(up.cpu().view(torch.int16), host.view(torch.int16))
    staged = stream._host_stack(x[4:8], q, pin=True)
    assert staged.is_pinned()
    assert torch.equal(staged.view(torch.int16), host[4:8].view(torch.int16))
    assert torch.equal(up.to(torch.float32).cpu(), host.to(torch.float32))
