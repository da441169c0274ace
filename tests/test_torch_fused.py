"""The port's one-pass prox chain (K5, ``kernels.prox_chain``) and fused
morphology update (K6, ``kernels.fused_morph_update``) against the JAX
package's Pallas kernels in interpret mode, and the fit configurations
that run them, on the CPU.  On CPU tensors the wrappers run their plain
versions; the CUDA kernels are held against those in
``test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

import __graft_entry__ as graft
from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.optim import AdaproxState as JState
from scarlet_tpu.ops import pallas_kernels as pk
from scarlet_tpu_torch import convert
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.optim import AdaproxState as TState

BOX = (21, 21)
B1, B2, EPS, FLOOR = 0.9, 0.999, 1e-8, 1e-20


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(K=6):
    """The inputs of tests/test_pallas_kernels.py's fused-kernel test: a
    gated-off slot, a box mask cutting columns, nonzero thresholds."""
    rng = np.random.RandomState(11)
    weights, keeps, n_iter = teng.monotonicity_tables(BOX, 1, "angle")
    morphs = rng.rand(K, *BOX).astype(np.float32)
    morphs[:, 10, 10] += 1.0
    grads = rng.randn(K, *BOX).astype(np.float32) * 0.1
    m = rng.randn(K, *BOX).astype(np.float32) * 0.05
    v = rng.rand(K, *BOX).astype(np.float32) * 0.01
    vhat = rng.rand(K, *BOX).astype(np.float32) * 0.01
    gate = np.array([True, True, False, True, True, False])[:K]
    bmask = np.ones((K, *BOX), np.float32)
    bmask[min(1, K - 1), :, :4] = 0.0
    thr = np.array([0.0, 0.02, 0.0, 0.05, 0.0, 0.0], np.float32)[:K]
    return dict(weights=weights.astype(np.float32),
                keeps=keeps.astype(np.float32), n_iter=n_iter,
                morphs=morphs, grads=grads, m=m, v=v, vhat=vhat, gate=gate,
                bmask=bmask, thr=thr)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tol,K", [(0.0, 6), (1e-3, 1)])
def test_prox_chain_matches_packed_chain_kernel(tol, K):
    """K5's plain version against ``monotonic_prox_packed_chain``; at
    tol > 0 with one slot (the TPU kernel's exit is per packed group)."""
    d = _inputs(K)
    hb, wb = BOX
    stepped = d["morphs"] * d["bmask"]
    c = hb // 2
    idx = np.argmax(stepped[:, c - 1:c + 2, c - 1:c + 2].reshape(K, 9),
                    axis=1).astype(np.int32)

    def pack(x):
        return np.ascontiguousarray(np.swapaxes(x, 0, 1).reshape(hb, K * wb))

    ref = np.asarray(pk.monotonic_prox_packed_chain(
        jnp.asarray(pack(d["morphs"] + 7.0)), jnp.asarray(pack(stepped)),
        jnp.asarray(idx), jnp.asarray(d["weights"]), jnp.asarray(d["keeps"]),
        jnp.asarray(np.repeat(d["thr"], wb)),
        jnp.asarray(np.repeat(d["gate"].astype(np.float32), wb)), wb,
        d["n_iter"], 0.0, FLOOR, interpret=True, tol=tol))
    got = kn.prox_chain(_t(d["morphs"] + 7.0), _t(stepped), _t(idx),
                        _t(d["weights"]), _t(d["keeps"]), _t(d["thr"]),
                        _t(d["gate"]), d["n_iter"], 0.0, FLOOR, tol=tol)
    assert got.dtype == torch.float32
    assert_allclose(pack(got.numpy()), ref, rtol=1e-6, atol=1e-7)
    # gated-off slots keep x_orig exactly
    off = ~d["gate"]
    assert_array_equal(got.numpy()[off], (d["morphs"] + 7.0)[off])


@pytest.mark.parametrize("it", [0, 3])
def test_fused_morph_update_matches_pallas(it):
    d = _inputs()
    step = 1e-2 * (0.1 if it == 0 else 1.0)
    jopt = JState(*(jnp.asarray(d[k]) for k in ("m", "v", "vhat")))
    ref_x, ref_opt = pk.fused_morph_update(
        jnp.asarray(d["morphs"]), jnp.asarray(d["grads"]), jopt,
        jnp.asarray(d["gate"]), jnp.asarray(d["weights"]),
        jnp.asarray(d["keeps"]), jnp.asarray(d["bmask"]),
        jnp.asarray(d["thr"]), jnp.asarray(np.float32(step)), d["n_iter"],
        0.0, 1, B1, B2, EPS, FLOOR, interpret=True)
    damp = torch.where(torch.tensor(it) > 0, 1.0, 0.1) * 1e-2
    got_x, got_opt = kn.fused_morph_update(
        _t(d["morphs"]), _t(d["grads"]),
        TState(*(_t(d[k]) for k in ("m", "v", "vhat"))), _t(d["gate"]),
        _t(d["weights"]), _t(d["keeps"]), _t(d["bmask"]), _t(d["thr"]),
        damp, d["n_iter"], 0.0, 1, B1, B2, EPS, FLOOR)
    assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=1e-6, atol=1e-7)
    # moments: the same f32 operations in the same order
    for a, b in zip(got_opt, ref_opt):
        assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=1e-6,
                        atol=1e-9)
    off = ~d["gate"]
    assert_array_equal(got_x.numpy()[off], d["morphs"][off])
    assert_array_equal(got_opt.m.numpy()[off], d["m"][off])


def test_fused_plain_is_the_unfused_chain():
    """Without the fusion: the engine's adaprox step, then the packed
    chain at tol 0 — the same bits, a batch of two blends, one of them at
    its first iteration (per-blend step damping)."""
    d = _inputs()
    morphs = _t(np.stack([d["morphs"], d["morphs"][::-1].copy()]))
    grads = _t(np.stack([d["grads"], d["grads"] * 2]))
    opt = TState(*(_t(np.stack([d[k], d[k]])) for k in ("m", "v", "vhat")))
    gate = _t(np.stack([d["gate"], d["gate"][::-1].copy()]))
    thr = _t(np.stack([d["thr"], d["thr"] * 0.5]))
    bmask = _t(np.stack([d["bmask"], d["bmask"]]))
    it = torch.tensor([0, 4], dtype=torch.int32)
    w, k = _t(d["weights"]), _t(d["keeps"])
    damp = torch.where(it > 0, 1.0, 0.1)
    x, mopt = kn.fused_morph_update(morphs, grads, opt, gate, w, k, bmask,
                                    thr, damp * 1e-2, d["n_iter"])
    from scarlet_tpu_torch.optim import adaprox_step

    stepped, sopt = adaprox_step(morphs, grads, it[:, None, None, None], opt,
                                 1e-2, prox=None)
    stepped = stepped * bmask
    idx = kn.candidate_index(stepped, 1)
    ref = kn.prox_chain(morphs, stepped, idx, w, k, thr, gate, d["n_iter"])
    assert torch.equal(x, ref)
    g3 = gate[..., None, None]
    for a, new, old in zip(mopt, sopt, opt):
        assert torch.equal(a, torch.where(g3, new, old))


def _port(config, data, state):
    return convert.from_jax(dataclasses.asdict(config), jax.device_get(data),
                            jax.device_get(state), device="cpu")


@pytest.mark.parametrize("extra", [
    dict(use_pallas_scene=True, packed_morphs=True, packed_prox_chain=True),
    dict(fuse_morph=True)], ids=["packed_prox_chain", "fuse_morph"])
def test_fit_scan_fused_configs_match_jax(extra):
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(32,), use_pallas=True,
                                 pallas_interpret=True, **extra)
    out_j, loss_j = jeng.fit_scan(state, data, config, 20)
    cfg, d, s = _port(config, data, state)
    assert teng.packed_morphs_ok(cfg) == jeng.packed_morphs_ok(config)
    kn.reset_launch_counts()
    out_t, loss_t = teng.fit_scan(s, d, cfg, 20)
    assert_allclose(to_numpy(loss_t), np.asarray(loss_j), rtol=1e-5)
    for field in ("seds", "morphs"):
        for a, b in zip(getattr(out_t, field), getattr(out_j, field)):
            assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert_allclose(to_numpy(out_t.morph_opt[0].v),
                    np.asarray(out_j.morph_opt[0].v), rtol=1e-4, atol=1e-9)
    assert_array_equal(to_numpy(out_t.it), np.asarray(out_j.it))


@pytest.mark.parametrize("fields", [
    dict(),
    dict(use_pallas=True, use_pallas_scene=True, packed_morphs=True),
    dict(use_pallas=True, packed_morphs=True),
    dict(use_pallas=True, use_pallas_scene=True, packed_morphs=True,
         bucket_counts=(70,)),
    dict(use_pallas=True, use_pallas_scene=True, packed_morphs=True,
         optimizer="fista")])
def test_packed_branch_rule_matches_jax(fields):
    config, _, _ = graft._demo_setup()
    config = dataclasses.replace(config, **fields)
    cfg = teng.LiteFitConfig(**dataclasses.asdict(config))
    assert teng.packed_morphs_ok(cfg) == jeng.packed_morphs_ok(config)


def _boundary_setup():
    """One slot whose pixel (0, 0) lies exactly on the background
    threshold: band 0's ``sed * x >= t`` holds (the any-band count keeps
    the pixel) while ``x < t / sed`` also holds (the packed cutoff cuts
    it).  No convolution, zero weights (so the step leaves morphs and
    seds alone) and no monotonicity passes (``mono_n_iters=0``): the fit
    step's morphology is the threshold, floor and normalization alone."""
    rng = np.random.default_rng(5)
    C, H, W, S = 2, 12, 12, 7
    p = np.float32(0.3)
    for s0 in rng.uniform(0.5, 2.0, 1000).astype(np.float32):
        t0 = np.float32(p * s0)
        if np.float32(t0 / s0) > p:
            break
    else:
        raise AssertionError("no boundary SED found")
    morph = rng.uniform(0.05, 0.9, (1, S, S)).astype(np.float32)
    morph[0, S // 2, S // 2] = 1.0
    morph[0, 0, 0] = p
    seds = np.array([[s0, 1.0]], np.float32)
    bg_rms = np.array([4 * t0, 100.0], np.float32)   # bg_thresh 0.25
    config = jeng.LiteFitConfig(
        scene_shape=(C, H, W), box_shapes=((S, S),), bucket_counts=(1,),
        fft_shape=None, mono_n_iters=(0,), bg_thresh=0.25)
    images = rng.uniform(size=(C, H, W)).astype(np.float32)
    data = jeng.make_blend_data(images, np.zeros_like(images), None, bg_rms,
                                config)
    state = jeng.make_blend_state(seds, morph,
                                  np.array([[2, 3]], np.int32))
    return config, data, state


def test_threshold_formula_follows_the_branch():
    """A converted accelerator config takes the packed branch's cutoff in
    both packages, the plain config the any-band count; on a boundary
    pixel the two formulas part."""
    config, data, state = _boundary_setup()
    accel = dataclasses.replace(config, use_pallas=True,
                                use_pallas_scene=True, packed_morphs=True,
                                pallas_interpret=True)
    got = {}
    for name, cfg_j in (("plain", config), ("packed", accel)):
        # fit_scan: the JAX fit_step takes the packed branch only for a
        # state that fit_scan has packed
        out_j, _ = jeng.fit_scan(state, data, cfg_j, 1)
        cfg, d, s = _port(cfg_j, data, state)
        assert teng.packed_morphs_ok(cfg) == (name == "packed")
        out_t, _ = teng.fit_scan(s, d, cfg, 1)
        got[name] = to_numpy(out_t.morphs[0])[0]
        assert_array_equal(got[name], np.asarray(out_j.morphs[0])[0])
    assert got["plain"][0, 0] == np.float32(0.3)
    assert got["packed"][0, 0] == 0.0
