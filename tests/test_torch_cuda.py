"""The CUDA kernels of scarlet_tpu_torch against their plain PyTorch
versions, on the card.  Every test is marked ``cuda`` and skips without a
CUDA device.

This file imports no JAX, so it runs where JAX is not installed (the
tests' conftest imports JAX, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
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


def _bucket(B, K, C=5, H=58, W=48, hb=BOX, pad=30, seed=1):
    rng = np.random.default_rng(seed)
    seds = rng.uniform(0.1, 2, (B, K, C)).astype(np.float32)
    morphs = rng.uniform(0, 1, (B, K, hb, hb)).astype(np.float32)
    oy = rng.integers(1 - pad, H - hb + pad, (B, K, 1))
    ox = rng.integers(1 - pad, W - hb + pad, (B, K, 1))
    origins = np.concatenate([oy, ox], -1).astype(np.int32)
    on = rng.uniform(size=(B, K)) > 0.2
    assert origins.min() < 0
    return [torch.from_numpy(x) for x in (seds, morphs, origins, on)]


@pytest.mark.cuda
def test_scene_and_grad_match_plain(cuda):
    C, H, W, P = 5, 58, 48, 30
    seds, morphs, origins, on = (x.to(cuda) for x in _bucket(4, 16))
    got = kn.scene_assembly(seds, morphs, origins, on, (C, H, W), P)
    ref = kn.scene_assembly_plain(seds, morphs, origins, on, (C, H, W), P)
    assert torch.equal(got, ref)
    gpad = F.pad(torch.randn(4, C, H, W, device=cuda), (P, P, P, P))
    gs, gm = kn.grad_gather(gpad, seds, morphs, origins, P)
    rs, rm = kn.grad_gather_plain(gpad, seds, morphs, origins, P)
    assert torch.equal(gm, rm)
    # g_sed: a block reduction, in another order than torch's sum
    scale = kn.grad_gather_plain(gpad.abs(), seds, morphs, origins, P)[0]
    assert bool(((gs - rs).abs() <= 1e-5 * scale).all())


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
