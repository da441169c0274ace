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
    w, keep, n_iter = engine.monotonicity_tables((box, box), 1, "angle")
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
@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_monotonic_prox_matches_plain(cuda, tol):
    w, keep, n_iter = _tables()
    m, idx = _morphs(2, 16)
    args = [x.to(cuda) for x in (m, idx, w, keep)]
    before = kn.monotonic_prox.launches
    got = kn.monotonic_prox(*args, n_iter, tol=tol)
    assert kn.monotonic_prox.launches == before + 1
    assert torch.equal(got, kn.monotonic_prox_plain(*args, n_iter, tol=tol))
    packed = args[0].transpose(-3, -2).reshape(2, BOX, 16 * BOX).contiguous()
    got_p = kn.monotonic_prox_packed(packed, *args[1:], BOX, n_iter,
                                     tol=tol)
    assert torch.equal(got_p, kn.monotonic_prox_packed_plain(
        packed, *args[1:], BOX, n_iter, tol=tol))
    assert torch.equal(got_p.reshape(2, BOX, 16, BOX).transpose(-3, -2),
                       got)


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
    assert all(n > 0 for n in kn.launch_counts().values())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    cpu.fit(30, e_rel=0.0)
    assert len(card.loss) == len(cpu.loss) == 30
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-4)
