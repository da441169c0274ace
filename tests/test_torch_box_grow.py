"""Logical box growth (``LiteFitConfig.box_grow``: the reference's
edge-pull box resize, ref morphology.py:160-207, inside the fixed physical
box) in the port against the JAX package on the CPU: the oversized-source
case of tests/test_box_growth.py, rebuilt on both sides.

Tolerances: the grown half-sizes and step scales exactly (a slot grows
when its edge pull passes 0.1; the pulls agree to float32 roundoff, far
from the threshold on this input); logL rtol 1e-4 (60 iterations of two
FFT-based fits); the growth helpers exactly, the edge pull to 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal
from scipy.signal import fftconvolve

from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.parallel import batch as jbatch
from scarlet_tpu.parallel import stream as jstream
from scarlet_tpu_torch import convert
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.lite.utils import integrated_circular_gaussian
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.parallel import batch as tbatch
from scarlet_tpu_torch.parallel import stream as tstream

BOX, HALF0 = 59, 7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (several test workers share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oversized():
    """A bright exponential source much larger than a half-7 init box,
    set up by both streams with ``box_grow=0.1``; the init masks are
    clipped to half-size 7, so the fit must grow the box to model the
    wings.  Returns ((jax config, data, state), (port ...))."""
    rng = np.random.default_rng(0)
    C, H, W = 3, 64, 64
    yy, xx = np.mgrid[:H, :W]
    prof = np.exp(-np.hypot(yy - 32, xx - 32) / 6.0).astype(np.float32)
    sed = np.asarray([1.0, 2.0, 1.5], np.float32)
    psf = integrated_circular_gaussian(sigma=1.2).astype(np.float32)
    truth = sed[:, None, None] * prof[None] * 30.0
    images = np.stack([fftconvolve(truth[c], psf, mode="same")
                       for c in range(C)]).astype(np.float32)
    variance = np.full_like(images, 0.01)
    images += rng.standard_normal(images.shape).astype(np.float32) * 0.1
    psfs = psf[None].repeat(C, 0)
    mp = integrated_circular_gaussian(sigma=0.8)[None].astype(np.float32)
    args = (images[None], variance[None], psfs[None],
            np.asarray([[[32, 32]]]), mp)
    kw = dict(box_size=BOX, n_slots=2, box_grow=0.1)
    bm = np.zeros((1, 2, BOX, BOX), np.float32)
    c = BOX // 2
    bm[:, :, c - HALF0:c + HALF0 + 1, c - HALF0:c + HALF0 + 1] = 1.0
    jcfg, jdata, jstate, _ = jstream.stream_setup(*args, platform="cpu",
                                                  **kw)
    tcfg, tdata, tstate, _ = tstream.stream_setup(*args, device="cpu", **kw)
    return ((jcfg, jdata._replace(box_masks=(jnp.asarray(bm),)), jstate),
            (tcfg, tdata._replace(box_masks=(torch.from_numpy(bm),)),
             tstate))


def _off(cfg, state):
    return (dataclasses.replace(cfg, box_grow=None),
            state._replace(box_half=None, step_scale=None))


def test_stream_setup_growth_state(oversized):
    (jcfg, _, jstate), (tcfg, _, tstate) = oversized
    assert tcfg.box_grow == jcfg.box_grow == 0.1
    assert tcfg.box_grow_step == jcfg.box_grow_step
    assert_array_equal(tstate.box_half[0].numpy(),
                       np.asarray(jstate.box_half[0]))
    assert tstate.box_half[0].dtype == torch.int32
    assert_array_equal(tstate.step_scale[0].numpy(),
                       np.asarray(jstate.step_scale[0]))


def test_growth_recovers_oversized_source_like_jax(oversized):
    """60 iterations with growth: the port's grown halves and step scales
    equal the JAX fit's, logL within rtol 1e-4; and the JAX test's
    assertions hold on the port (tests/test_box_growth.py:55-66)."""
    (jcfg, jdata, jstate), (tcfg, tdata, tstate) = oversized
    out_j, _ = jbatch.fit_batch_device_converged(jstate, jdata, jcfg, 60,
                                                 check_every=20)
    out_g, _ = tbatch.fit_batch_device_converged(tstate, tdata, tcfg, 60,
                                                 check_every=20)
    cfg_ng, st_ng = _off(tcfg, tstate)
    out_ng, _ = tbatch.fit_batch_device_converged(st_ng, tdata, cfg_ng, 60,
                                                  check_every=20)
    half = out_g.box_half[0][0].numpy()
    scale = out_g.step_scale[0][0].numpy()
    assert_array_equal(half, np.asarray(out_j.box_half[0][0]))
    assert_array_equal(scale, np.asarray(out_j.step_scale[0][0]))
    assert_array_equal(out_g.it.numpy(), np.asarray(out_j.it))
    logl_g, logl_ng = float(out_g.last_loss[0]), float(out_ng.last_loss[0])
    assert np.isfinite(logl_g)
    assert_allclose(logl_g, float(out_j.last_loss[0]), rtol=1e-4)
    # boxes grew (in +5 steps), steps halved per growth, and the fit
    # improved by more than half the magnitude of the fixed-box logL
    assert half.max() > HALF0
    assert np.all(scale[half > HALF0] < 1.0)
    assert logl_g > logl_ng + 0.5 * abs(logl_ng)
    # growth stays inside the physical box
    assert half.max() <= BOX // 2


def test_growth_state_is_inert_when_off(oversized):
    """``box_grow=None`` with the state fields carried through leaves
    them as they were and fits exactly as without them."""
    _, (cfg, data, state) = oversized
    cfg_ng, st_none = _off(cfg, state)
    out_a, _ = tbatch.fit_batch_device_converged(st_none, data, cfg_ng, 10,
                                                 check_every=10)
    out_b, _ = tbatch.fit_batch_device_converged(state, data, cfg_ng, 10,
                                                 check_every=10)
    assert torch.equal(out_b.box_half[0], state.box_half[0])
    assert torch.equal(out_b.step_scale[0], state.step_scale[0])
    assert torch.equal(out_a.morphs[0], out_b.morphs[0])
    assert out_a.box_half is None


@pytest.mark.parametrize("chain", [False, True])
def test_growth_packed_branch_matches_plain(oversized, chain):
    """The accelerator configuration (the packed branch: the grown mask
    before the projection, or before the K5 chain) against the plain
    branch: the same grown halves, logL within rtol 1e-3 (the JAX
    package's bound for its packed growth path, whose threshold is a
    per-slot cutoff)."""
    _, (cfg, data, state) = oversized
    out_x, _ = tbatch.fit_batch_device_converged(state, data, cfg, 30,
                                                 check_every=10)
    cfg_p = dataclasses.replace(cfg, use_pallas=True, use_pallas_scene=True,
                                packed_morphs=True, packed_prox_chain=chain)
    assert teng.packed_morphs_ok(cfg_p)
    out_p, _ = tbatch.fit_batch_device_converged(state, data, cfg_p, 30,
                                                 check_every=10)
    assert torch.equal(out_p.box_half[0], out_x.box_half[0])
    assert int(out_p.box_half[0].max()) > HALF0
    assert_allclose(out_p.last_loss.numpy(), out_x.last_loss.numpy(),
                    rtol=1e-3)


def test_fused_update_does_not_run_while_growing(oversized, monkeypatch):
    """K6 (``fuse_morph``) is skipped while boxes grow, as in the JAX
    package (engine.py:937-943), and runs when growth is off."""
    _, (cfg, data, state) = oversized
    cfg_f = dataclasses.replace(cfg, use_pallas=True, fuse_morph=True)
    calls = []
    fused = kn.fused_morph_update

    def spy(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    monkeypatch.setattr(teng.kernels, "fused_morph_update", spy)
    out, _ = teng.fit_step(state, data, cfg_f)
    assert not calls and out.box_half is not None
    cfg_ng, st_ng = _off(cfg_f, state)
    teng.fit_step(st_ng, data, cfg_ng)
    assert calls == [1]


def test_growth_helpers_match_jax():
    """``_base_half``, ``_grown_mask_stack`` and ``_edge_pull`` on random
    masks, halves and moments, against the JAX helpers (the edge pull on
    its (hb, K, wb) view)."""
    rng = np.random.default_rng(3)
    K, hb = 4, 21
    bc = (hb // 2, hb // 2)
    base = np.zeros((K, hb, hb), np.float32)
    for k, h in enumerate((2, 5, 7, 3)):
        base[k, bc[0] - h:bc[0] + h + 1, bc[1] - h + 1:bc[1] + h] = 1.0
    half = np.array([-1, 7, 4, 9], np.int32)
    got_h = teng._base_half(torch.from_numpy(base), bc)
    assert_array_equal(got_h.numpy(),
                       np.asarray(jeng._base_half(jnp.asarray(base), bc)))
    assert_array_equal(
        teng._grown_mask_stack(torch.from_numpy(base),
                               torch.from_numpy(half), bc).numpy(),
        np.asarray(jeng._grown_mask_stack(jnp.asarray(base),
                                          jnp.asarray(half), bc)))
    x = rng.uniform(-0.2, 1, (K, hb, hb)).astype(np.float32)
    m = rng.normal(size=(K, hb, hb)).astype(np.float32)
    v = np.where(rng.uniform(size=(K, hb, hb)) > 0.2,
                 rng.uniform(0, 0.1, (K, hb, hb)), 0).astype(np.float32)
    step = rng.uniform(0.001, 0.01, K).astype(np.float32)
    h_eff = np.maximum(np.asarray(got_h), half)
    got = teng._edge_pull(torch.from_numpy(x), torch.from_numpy(m),
                          torch.from_numpy(v), torch.from_numpy(step),
                          torch.from_numpy(h_eff), bc)
    view = lambda a: jnp.asarray(np.moveaxis(a, 0, 1))  # noqa: E731
    ref = jeng._edge_pull_view(view(x), view(m), view(v), jnp.asarray(step),
                               jnp.asarray(h_eff), bc)
    assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)


def test_growth_from_jax_round_trip(oversized):
    """``convert.from_jax`` carries the growth state over exactly, and a
    converted fit grows as the port's own setup does."""
    (jcfg, jdata, jstate), (tcfg, tdata, tstate) = oversized
    jout, _ = jbatch.fit_batch(jstate, jdata, jcfg, 12)
    cfg, d, s = convert.from_jax(dataclasses.asdict(jcfg),
                                 jax.device_get(jdata),
                                 jax.device_get(jout), device="cpu")
    assert cfg == tcfg
    assert_array_equal(s.box_half[0].numpy(), np.asarray(jout.box_half[0]))
    assert s.box_half[0].dtype == torch.int32
    assert_array_equal(s.step_scale[0].numpy(),
                       np.asarray(jout.step_scale[0], np.float32))
    tout, _ = teng.fit_scan(tstate, tdata, tcfg, 12)
    assert torch.equal(tout.box_half[0], s.box_half[0])
    assert torch.equal(tout.step_scale[0], s.step_scale[0])
