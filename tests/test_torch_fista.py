"""FISTA in the port (``optim.fista_step``, ``lite.FistaParameter``,
``lite.init_fista_component``, the engine's FISTA fit through
``LiteBlend`` and ``pack_blends``) and ``parallel.fit_batch_converged``
against the JAX package on the CPU, on generated blends.

Tolerances: ``fista_step`` bit for bit (the same float32 operations in
the same order); a 10-iteration ``LiteBlend`` fit max |dmorph| <= 1e-5
and logL rtol 1e-5 (the two FFTs and sums differ at float32 roundoff);
states carried over by ``convert.from_jax`` exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu import lite as jlite
from scarlet_tpu import optim as joptim
from scarlet_tpu import parallel as jpar
from scarlet_tpu_torch import convert
from scarlet_tpu_torch import lite as tlite
from scarlet_tpu_torch import optim as toptim
from scarlet_tpu_torch import parallel as tpar
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.testing import generate_blend


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_fista_step_bitwise_jax(active):
    """A stack of 3 SEDs with one t each, against the JAX step of each
    one alone (as the JAX engine vmaps it)."""
    rng = np.random.default_rng(0)
    x, g, z = (rng.normal(size=(3, 5)).astype(np.float32) for _ in range(3))
    t = np.array([1.0, 2.5, 7.25], np.float32)
    step = rng.uniform(0.01, 0.1, 3).astype(np.float32)
    st = toptim.FistaState(torch.from_numpy(z), torch.from_numpy(t))
    xt, sn = toptim.fista_step(
        torch.from_numpy(x), torch.from_numpy(g), 4, st,
        torch.from_numpy(step)[:, None],
        prox=lambda y, s: torch.clamp_min(y, 0.0),
        active=None if active is None else torch.tensor(active))
    for k in range(3):
        js = joptim.FistaState(jnp.asarray(z[k]), jnp.asarray(t[k]))
        jx, jn = joptim.fista_step(
            jnp.asarray(x[k]), jnp.asarray(g[k]), 4, js, step[k],
            prox=lambda y, s: jnp.maximum(y, 0.0),
            active=None if active is None else jnp.asarray(active[k]))
        assert_array_equal(xt[k].numpy(), np.asarray(jx))
        assert_array_equal(sn.z[k].numpy(), np.asarray(jn.z))
        assert_array_equal(sn.t[k].numpy(), np.asarray(jn.t))


def test_fista_state_and_parameter_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(5,)).astype(np.float32)
    st = toptim.init_fista_state(torch.from_numpy(x))
    assert st.t.dtype == torch.float32 and float(st.t) == 1.0
    assert torch.equal(st.z, torch.from_numpy(x))
    other = rng.uniform(size=(7, 7)).astype(np.float32)
    grad = rng.normal(size=(5,)).astype(np.float32)
    pj = jlite.FistaParameter(x, step=0.3, grad=lambda g, x, *a: g,
                              prox=lambda y, s: jnp.maximum(y, 0.0))
    pt = tlite.FistaParameter(x, step=0.3, grad=lambda g, x, *a: g,
                              prox=lambda y, s: torch.clamp_min(y, 0.0))
    for it in range(3):
        pj.update(it, jnp.asarray(grad), jnp.asarray(other))
        pt.update(it, torch.from_numpy(grad), torch.from_numpy(other))
    assert_allclose(pt.x.numpy(), np.asarray(pj.x), rtol=1e-6)
    assert_allclose(pt.z.numpy(), np.asarray(pj.z), rtol=1e-6)
    assert pt.t == pytest.approx(pj.t, rel=1e-7)
    m = tlite.FistaParameter(np.ones((5, 5), np.float32), step=1.0)
    m.grow((9, 9), 2)
    assert m.x.shape == m.z.shape == (9, 9)
    m.shrink(2)
    assert m.x.shape == m.z.shape == (5, 5) and m.t == 1.0


def _noise_rms(d):
    # both sides get the same exact noise rms (the JAX package's float32
    # mean drifts by ~1e-5 relative)
    return np.sqrt(d["variance"].astype(np.float64)).mean(
        axis=(1, 2)).astype(np.float32)


def _blend(lite, d, param):
    w = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    mp = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = lite.LiteObservation(d["images"], d["variance"], w, d["psfs"],
                               model_psf=mp, noise_rms=_noise_rms(d),
                               **({"device": "cpu"} if lite is tlite
                                  else {}))
    centers = [(int(round(r["y"])), int(round(r["x"])))
               for r in d["catalog"]]
    src = lite.init_all_sources_main(obs, centers, min_snr=50)
    return lite.LiteBlend(lite.parameterize_sources(
        src, obs, getattr(lite, param)), obs)


def _pair(seed, param="init_fista_component"):
    d = generate_blend(np.random.default_rng(seed))
    return _blend(jlite, d, param), _blend(tlite, d, param)


def test_init_fista_component_matches_jax():
    jb, tb = _pair(0)
    assert len(jb.components) == len(tb.components)
    for cj, ct in zip(jb.components, tb.components):
        assert isinstance(ct._sed, tlite.FistaParameter)
        assert isinstance(ct._morph, tlite.FistaParameter)
        assert ct._sed.step == pytest.approx(cj._sed.step, rel=1e-6)
        assert ct._morph.step == pytest.approx(cj._morph.step, rel=1e-6)
        assert ct.bg_thresh is None and cj.bg_thresh is None
        assert_allclose(to_numpy(ct._sed.z), np.asarray(cj._sed.z),
                        rtol=1e-5, atol=1e-6)
        assert ct._morph.t == 1.0


@pytest.mark.parametrize("seed", [0, 2])
def test_fista_lite_blend_fit_matches_jax(seed):
    """A FISTA ``LiteBlend``'s 10-iteration fit (e_rel 0, one segment):
    logL rtol 1e-5 at every iteration, max |dmorph| <= 1e-5, and the
    written-back FISTA states as close."""
    jb, tb = _pair(seed)
    jb.fit(10, e_rel=0.0, resize=None, reweight=False)
    tb.fit(10, e_rel=0.0, resize=None, reweight=False)
    assert tb.it == jb.it == 10
    assert_allclose(tb.loss, jb.loss, rtol=1e-5)
    assert np.isfinite(tb.loss).all() and tb.loss[-1] > tb.loss[0]
    for cj, ct in zip(jb.components, tb.components):
        assert np.abs(to_numpy(ct.morph) - np.asarray(cj.morph)).max() \
            <= 1e-5
        assert_allclose(to_numpy(ct.sed), np.asarray(cj.sed), rtol=1e-5,
                        atol=1e-6)
        assert isinstance(ct._morph.state, toptim.FistaState)
        assert ct._morph.t == pytest.approx(cj._morph.t, rel=1e-6)
        assert np.abs(to_numpy(ct._morph.z)
                      - np.asarray(cj._morph.z)).max() <= 1e-5


def test_fista_setup_and_from_jax_round_trip():
    """``engine_setup`` of a FISTA blend: the optimizer, the base steps
    and the FISTA states equal the JAX package's, and ``convert.from_jax``
    carries the JAX setup over exactly."""
    jb, tb = _pair(1)
    jcfg, jdata, jstate = jb.engine_setup()
    tcfg, tdata, tstate = tb.engine_setup()
    assert tcfg.optimizer == jcfg.optimizer == "fista"
    assert_allclose(tdata.fista_step[0].numpy(),
                    np.asarray(jdata.fista_step[0]), rtol=1e-6)
    for tb_opt, jb_opt in ((tstate.sed_opt[0], jstate.sed_opt[0]),
                           (tstate.morph_opt[0], jstate.morph_opt[0])):
        assert isinstance(tb_opt, toptim.FistaState)
        assert_allclose(tb_opt.z.numpy(), np.asarray(jb_opt.z), rtol=1e-5,
                        atol=1e-6)
        assert_array_equal(tb_opt.t.numpy(), np.asarray(jb_opt.t))
    cfg, d, s = convert.from_jax(dataclasses.asdict(jcfg),
                                 jax.device_get(jdata),
                                 jax.device_get(jstate), device="cpu")
    assert cfg == teng.LiteFitConfig(**dataclasses.asdict(jcfg))
    assert_array_equal(d.fista_step[0].numpy(),
                       np.asarray(jdata.fista_step[0], np.float32))
    for opt, jopt in ((s.sed_opt[0], jstate.sed_opt[0]),
                      (s.morph_opt[0], jstate.morph_opt[0])):
        assert isinstance(opt, toptim.FistaState)
        assert_array_equal(opt.z.numpy(), np.asarray(jopt.z, np.float32))
        assert_array_equal(opt.t.numpy(), np.asarray(jopt.t, np.float32))
    assert s.box_half is None and s.step_scale is None


def test_fista_pack_blends_matches_jax_batch():
    """``pack_blends`` stacks the FISTA steps and states; the batched fit
    of 3 FISTA blends against the JAX package's (logL rtol 1e-5)."""
    pairs = [_pair(seed) for seed in (0, 1, 2)]
    jcfg, jdata, jstate = jpar.pack_blends([p[0] for p in pairs],
                                           platform="cpu")
    tcfg, tdata, tstate = tpar.pack_blends([p[1] for p in pairs])
    assert tcfg.optimizer == "fista"
    assert tdata.fista_step[0].shape == (3, tcfg.bucket_counts[0])
    assert tstate.morph_opt[0].t.shape == (3, tcfg.bucket_counts[0])
    jout, jl = jpar.fit_batch(jstate, jdata, jcfg, 8)
    tout, tl = tpar.fit_batch(tstate, tdata, tcfg, 8)
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_fit_batch_converged_matches_device_converged():
    """The host-checked segments of ``fit_batch_converged`` give the
    states, losses and iteration counts of ``fit_batch_device_converged``
    (both stop once every blend has converged), leave the caller's state
    as it was, and match the JAX package's ``fit_batch_converged``."""
    pairs = [_pair(seed, "init_adaprox_component") for seed in (0, 1, 2)]
    jcfg, jdata, jstate = jpar.pack_blends([p[0] for p in pairs],
                                           platform="cpu")
    cfg, data, state = tpar.pack_blends([p[1] for p in pairs])
    assert tpar.BatchConfig is teng.LiteFitConfig
    out, losses = tpar.fit_batch_converged(state, data, cfg, 40, segment=10)
    ref, ref_losses = tpar.fit_batch_device_converged(state, data, cfg, 40,
                                                      check_every=10)
    assert int(state.it.max()) == 0
    assert torch.equal(losses, ref_losses)
    assert torch.equal(out.it, ref.it)
    assert torch.equal(out.morphs[0], ref.morphs[0])
    jout, jl = jpar.fit_batch_converged(jstate, jdata, jcfg, 40, segment=10)
    assert_array_equal(out.it.numpy(), np.asarray(jout.it))
    assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-4)
