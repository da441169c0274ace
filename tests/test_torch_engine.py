"""The port's fit engine, optimizer, FFT and prox modules against the JAX
package on the CPU, on the same numpy inputs (``__graft_entry__``'s tiny
demo blend for the engine)."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

import __graft_entry__ as graft
from scarlet_tpu import optim as joptim
from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.ops import fft as jfft
from scarlet_tpu.ops import prox as jprox
from scarlet_tpu_torch import convert, optim as toptim
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.ops import fft as tfft
from scarlet_tpu_torch.ops import prox as tprox
from scarlet_tpu_torch.parallel import batch as tbatch


def _port(config, data, state):
    return convert.from_jax(dataclasses.asdict(config), jax.device_get(data),
                            jax.device_get(state), device="cpu")


def _assert_states_close(out_t, out_j, rtol=1e-5, atol=1e-5):
    for field in ("seds", "morphs"):
        for a, b in zip(getattr(out_t, field), getattr(out_j, field)):
            assert_allclose(to_numpy(a), np.asarray(b), rtol=rtol, atol=atol)
    assert_array_equal(to_numpy(out_t.it), np.asarray(out_j.it))
    assert_array_equal(to_numpy(out_t.active), np.asarray(out_j.active))


# the demo config's mono_n_iters=(14,) is below the DAG depth (32 at box
# 21): the XLA branch then stops after exactly 14 passes, while the TPU
# kernel and the port run 4-pass blocks (16 passes).  At a multiple of 4
# (16, or the depth 32) the two rules agree.
@pytest.mark.parametrize("path,n_iter", [
    ("xla", 16), ("xla", 32), ("pallas_interpret", 14)])
def test_fit_scan_matches_jax(path, n_iter):
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(n_iter,))
    if path == "pallas_interpret":
        # the accelerator configuration: all three kernels, lane-packed
        config = dataclasses.replace(
            config, use_pallas=True, use_pallas_scene=True,
            packed_morphs=True, pallas_interpret=True)
    out_j, loss_j = jeng.fit_scan(state, data, config, 20)
    cfg, d, s = _port(config, data, state)
    out_t, loss_t = teng.fit_scan(s, d, cfg, 20)
    assert loss_t.shape == (20,) and loss_t.dtype == torch.float32
    assert_allclose(to_numpy(loss_t), np.asarray(loss_j), rtol=1e-5)
    _assert_states_close(out_t, out_j)


@pytest.mark.parametrize("mask", [None, "edge"])
def test_fit_step_reads_the_gradient_unpadded(mask, monkeypatch):
    """The port's fit_step hands grad_gather the scene gradient unpadded
    (pad 0), where the JAX fit_step pads it: without a scene mask the
    strided crop of the inverse FFT itself, with one the masked product.
    Both match the JAX fit_step."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(16,))
    if mask is not None:
        m = np.ones(config.scene_shape[1:], np.float32)
        m[:, -6:] = 0.0
        data = data._replace(scene_mask=jnp.asarray(m))
    out_j, logl_j = jeng.fit_step(state, data, config)
    cfg, d, s = _port(config, data, state)
    seen = []
    gather = teng.kernels.grad_gather

    def spy(grad, seds, morphs, origins, pad):
        seen.append((grad.is_contiguous(), pad))
        return gather(grad, seds, morphs, origins, pad)

    monkeypatch.setattr(teng.kernels, "grad_gather", spy)
    out_t, logl_t = teng.fit_step(s, d, cfg)
    assert seen == [(mask is not None, 0)]
    assert_allclose(float(logl_t), float(logl_j), rtol=1e-6)
    _assert_states_close(out_t, out_j)


def test_fit_scan_batch_matches_single_blends():
    """A leading batch axis gives each blend's own fit."""
    config, data, state = graft._demo_setup()
    cfg, d, s = _port(dataclasses.replace(config, mono_n_iters=(32,)),
                      data, state)
    d2 = d._replace(images=d.images * 1.5)
    singles = [teng.fit_scan(s, dd, cfg, 8) for dd in (d, d2)]
    bd, bs = tbatch.pack_batch([(d, s), (d2, s)])
    out, losses = teng.fit_scan(bs, bd, cfg, 8)
    assert losses.shape == (8, 2)
    for i, (o, l) in enumerate(singles):
        assert_allclose(losses[:, i].numpy(), l.numpy(), rtol=1e-6)
        assert_allclose(out.morphs[0][i].numpy(), o.morphs[0].numpy(),
                        rtol=1e-5, atol=1e-6)
    rd, rs = tbatch.replicate_blend(d, s, 3)
    assert rd.mono_weights[0].shape == d.mono_weights[0].shape
    _, rlosses = teng.fit_scan(rs, rd, cfg, 8)
    for i in range(3):
        assert_allclose(rlosses[:, i].numpy(), singles[0][1].numpy(),
                        rtol=1e-6)


def test_convert_types_and_layout():
    config, data, state = graft._demo_setup()
    cfg, d, s = _port(config, data, state)
    assert cfg == teng.LiteFitConfig(**dataclasses.asdict(config))
    assert d.kernel_rfft.dtype == torch.complex64
    assert d.kernel_rfft.shape == data.kernel_rfft.shape[1:]
    assert_allclose(d.kernel_rfft.real.numpy(),
                    np.asarray(data.kernel_rfft[0], np.float32))
    assert s.origins[0].dtype == torch.int32
    assert s.it.dtype == torch.int32 and s.last_loss.dtype == torch.float32
    assert s.active.dtype == torch.bool
    assert isinstance(s.morph_opt[0], toptim.AdaproxState)


def test_make_blend_data_matches_jax():
    config, data, _ = graft._demo_setup()
    images = np.asarray(data.images)
    diff = np.asarray(jfft.match_psf(
        *graft_psfs(), return_fourier=False))
    tdata = teng.make_blend_data(images, np.asarray(data.weights), diff,
                                 np.full(3, 0.1, np.float32), config,
                                 device="cpu")
    jdata = jeng.make_blend_data(images, np.asarray(data.weights), diff,
                                 np.full(3, 0.1, np.float32), config)
    k = np.asarray(jdata.kernel_rfft)
    assert_allclose(tdata.kernel_rfft.real.numpy(), k[0], atol=1e-6)
    assert_allclose(tdata.grad_kernel_rfft.imag.numpy(),
                    np.asarray(jdata.grad_kernel_rfft)[1], atol=1e-6)
    assert_array_equal(tdata.mono_weights[0].numpy(),
                       np.asarray(jdata.mono_weights[0]))


def graft_psfs():
    from scarlet_tpu_torch.lite.utils import integrated_circular_gaussian

    psf = integrated_circular_gaussian(sigma=1.2).astype(np.float32)
    model = integrated_circular_gaussian(sigma=0.6)[None].astype(np.float32)
    return np.repeat(psf[None], 3, 0), model


def _random_moments(state, rng):
    """The demo state with random morphologies and morphology moments, so
    that a wrong layout shows in every leaf."""
    def rand(x):
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))

    return state._replace(morphs=(rand(state.morphs[0]),),
                          morph_opt=(joptim.AdaproxState(*(
                              rand(x) for x in state.morph_opt[0])),))


@pytest.mark.parametrize("batched", [False, True])
def test_pack_state_matches_jax(batched):
    """``pack_state``/``unpack_state`` on a config whose fit runs the
    packed branch (``packed_morphs_ok``): every packed leaf bit for bit
    against the JAX package's, on a single and a batched state, and the
    round trip gives the state back bit for bit."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, use_pallas=True,
                                 use_pallas_scene=True, packed_morphs=True)
    assert jeng.packed_morphs_ok(config)
    rng = np.random.default_rng(9)
    state = _random_moments(state, rng)
    if batched:
        other = _random_moments(state, rng)
        state = jax.tree.map(lambda a, b: jnp.stack([a, b]), state, other)
    cfg, _, s = _port(config, data, state)
    assert teng.packed_morphs_ok(cfg)
    packed_j = jeng.pack_state(state, config)
    packed_t = teng.pack_state(s, cfg)
    K, (hb, wb) = config.bucket_counts[0], config.box_shapes[0]
    lead = (2,) if batched else ()
    assert packed_t.morphs[0].shape == lead + (hb, K * wb)
    for got, ref in zip((packed_t.morphs[0], *packed_t.morph_opt[0]),
                        (packed_j.morphs[0], *packed_j.morph_opt[0])):
        assert_array_equal(got.numpy(), np.asarray(ref))
    back = teng.unpack_state(packed_t, cfg)
    for got, ref in zip((back.morphs[0], *back.morph_opt[0]),
                        (s.morphs[0], *s.morph_opt[0])):
        assert got.is_contiguous()
        assert torch.equal(got, ref)
    back_j = jeng.unpack_state(packed_j, config)
    assert_array_equal(back.morphs[0].numpy(), np.asarray(back_j.morphs[0]))


def test_pack_state_is_a_no_op_off_the_packed_branch():
    """Without ``packed_morphs`` (or with FISTA, or two buckets) both
    functions hand the state back as it is, as in the JAX package."""
    config, data, state = graft._demo_setup()
    cfg, _, s = _port(config, data, state)
    for c in (cfg, dataclasses.replace(cfg, use_pallas=True,
                                       use_pallas_scene=True,
                                       packed_morphs=True,
                                       optimizer="fista")):
        assert not teng.packed_morphs_ok(c)
        assert teng.pack_state(s, c) is s
        assert teng.unpack_state(s, c) is s
    assert jeng.pack_state(state, config) is state


def test_band_axis_without_a_band_group_raises():
    """A band axis reaches the engine through ``parallel.fit_batch_sharded``
    (tests/test_torch_sharded.py); set on a config outside it, with no
    band process group, the fit raises before any work."""
    config, data, state = graft._demo_setup()
    cfg, d, s = _port(config, data, state)
    cfg = dataclasses.replace(cfg, band_axis="bands", n_bands_total=3)
    with pytest.raises(ValueError, match="band_axis='bands'"):
        teng.fit_step(s, d, cfg)


def _with_option(field, value, config, data, state):
    """The demo blend set up for one fit option, on the JAX side: FISTA
    states and base steps; growth's box masks (half-size 5) and state;
    the accelerator configuration (the JAX kernels in interpret mode) for
    the tolerance schedule, on one component so that the TPU kernel's
    group exits are the port's."""
    from scarlet_tpu import optim as jopt

    config = dataclasses.replace(config, mono_n_iters=(32,),
                                 **{field: value})
    K, box = config.bucket_counts[0], config.box_shapes[0][0]
    if field == "optimizer":
        data = data._replace(fista_step=(jnp.full((K,), 0.5, jnp.float32),))
        # one t per component, as LiteBlend.engine_setup stacks them
        state = state._replace(
            sed_opt=tuple(jopt.FistaState(x, jnp.ones((K,), jnp.float32))
                          for x in state.seds),
            morph_opt=tuple(jopt.FistaState(x, jnp.ones((K,), jnp.float32))
                            for x in state.morphs))
    elif field == "box_grow":
        mask = np.zeros((K, box, box), np.float32)
        c = box // 2
        mask[:, c - 5:c + 6, c - 5:c + 6] = 1.0
        data = data._replace(box_masks=(jnp.asarray(mask),))
        state = state._replace(box_half=(jnp.full((K,), -1, jnp.int32),),
                               step_scale=(jnp.ones((K,), jnp.float32),))
    elif field in ("mono_tol_switch", "mono_every"):
        config = dataclasses.replace(
            config, bucket_counts=(1,), mono_tol_early=1e-2,
            use_pallas=True, use_pallas_scene=True, packed_morphs=True,
            pallas_interpret=True)
        state = jeng.make_blend_state(
            np.asarray(state.seds[0][:1]), np.asarray(state.morphs[0][:1]),
            np.asarray(state.origins[0][:1]))
    return config, data, state


@pytest.mark.parametrize("field,value", [
    ("optimizer", "fista"), ("box_grow", 0.1), ("mono_tol_switch", 5),
    ("mono_every", 2), ("conv_mode", "dft")])
def test_ported_options_run_like_jax(field, value):
    """Each option that once raised runs: one fit_step with the option
    after a first one (the logL of a step is that of the state it
    starts from), against the JAX package's with the same option: logL
    finite and within rtol 1e-5, the state's fields as close."""
    config, data, state = _with_option(field, value,
                                       *graft._demo_setup())
    out_j, loss_j = jeng.fit_scan(state, data, config, 2)
    cfg, d, s = _port(config, data, state)
    assert getattr(cfg, field) == value
    s1, _ = teng.fit_step(s, d, cfg)
    out_t, logl = teng.fit_step(s1, d, cfg)
    assert np.isfinite(float(logl))
    assert_allclose(float(logl), float(loss_j[1]), rtol=1e-5)
    _assert_states_close(out_t, out_j)
    if field == "optimizer":
        for a, b in zip(out_t.morph_opt[0], out_j.morph_opt[0]):
            assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5,
                            atol=1e-5)
    if field == "box_grow":
        assert_array_equal(to_numpy(out_t.box_half[0]),
                           np.asarray(out_j.box_half[0]))
        assert_array_equal(to_numpy(out_t.step_scale[0]),
                           np.asarray(out_j.step_scale[0]))


def test_static_mono_tol_runs_close_to_exact():
    """A static tolerance applies on the accelerator configuration (the
    only one that reads it) and stays close to the exact projection."""
    config, data, state = graft._demo_setup()
    cfg, d, s = _port(dataclasses.replace(config, mono_n_iters=(32,)),
                      data, state)
    _, exact = teng.fit_scan(s, d, cfg, 10)
    cfg_acc = dataclasses.replace(cfg, use_pallas=True,
                                  use_pallas_scene=True, packed_morphs=True)
    _, loose = teng.fit_scan(s, d, dataclasses.replace(cfg_acc,
                                                       mono_tol=1e-3), 10)
    assert abs(float(loose[-1] - exact[-1])) < 1e-3 * abs(float(exact[-1]))


def test_plain_branch_ignores_mono_tol_like_jax():
    """On a ``use_pallas=False`` config the JAX engine's plain projection
    ignores ``mono_tol`` and runs its ``n_iter`` passes; the port's does
    the same (tol 0), so both agree to the roundoff of the exact run:
    max |dmorph| <= 1e-6, logL rtol 1e-6 (with the tolerance applied the
    port was off by 2.56e-6 and 3.48e-6)."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(32,), mono_tol=1e-3)
    assert not config.use_pallas
    out_j, loss_j = jeng.fit_scan(state, data, config, 10)
    cfg, d, s = _port(config, data, state)
    assert cfg.mono_tol == 1e-3
    out_t, loss_t = teng.fit_scan(s, d, cfg, 10)
    assert_allclose(to_numpy(loss_t), np.asarray(loss_j), rtol=1e-6)
    for a, b in zip(out_t.morphs, out_j.morphs):
        assert np.abs(to_numpy(a) - np.asarray(b)).max() <= 1e-6


def test_tf32_pinned_off_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    teng.pin_float32("cpu")
    assert torch.backends.cuda.matmul.allow_tf32
    teng.pin_float32("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", toptim.SCHEMES)
@pytest.mark.parametrize("it", [0, 3])
def test_phi_psi_and_adaprox_step_match_jax(scheme, it):
    rng = np.random.default_rng(10)
    x, g, m = (rng.normal(size=(4, 7)).astype(np.float32) for _ in range(3))
    v, vhat = (rng.uniform(0, 0.1, (4, 7)).astype(np.float32)
               for _ in range(2))
    jstate = joptim.AdaproxState(*(jnp.asarray(a) for a in (m, v, vhat)))
    tstate = toptim.AdaproxState(*(torch.from_numpy(a) for a in (m, v,
                                                                 vhat)))
    jphi, jpsi, jst = joptim.phi_psi(scheme, it, jnp.asarray(g), jstate)
    tphi, tpsi, tst = toptim.phi_psi(scheme, it, torch.from_numpy(g),
                                     tstate)
    for a, b in zip((tphi, tpsi, *tst), (jphi, jpsi, *jst)):
        assert_allclose(to_numpy(a), np.asarray(b, np.float32), rtol=1e-5,
                        atol=1e-7)
    step = np.float32(0.01)
    active = np.array([True, False, True, True])[:, None]
    jx, _ = joptim.adaprox_step(jnp.asarray(x), jnp.asarray(g), it, jstate,
                                step, scheme=scheme,
                                prox=lambda z, s: jnp.maximum(z, 0.0),
                                active=jnp.asarray(active))
    tx, _ = toptim.adaprox_step(torch.from_numpy(x), torch.from_numpy(g), it,
                                tstate, step, scheme=scheme,
                                prox=lambda z, s: torch.clamp_min(z, 0.0),
                                active=torch.from_numpy(active))
    assert_allclose(tx.numpy(), np.asarray(jx, np.float32), rtol=1e-5,
                    atol=1e-7)


def test_adaprox_step_batched_iterations():
    """One iteration count per blend: damping 0.1 only where it == 0."""
    rng = np.random.default_rng(11)
    x, g = (torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
            for _ in range(2))
    st = toptim.init_adaprox_state(x)
    it = torch.tensor([0, 5], dtype=torch.int32)[:, None]
    xb, _ = toptim.adaprox_step(x, g, it, st, 0.01)
    for i, n in enumerate((0, 5)):
        xs, _ = toptim.adaprox_step(x[i], g[i], n, toptim.init_adaprox_state(
            x[i]), 0.01)
        assert_allclose(xb[i].numpy(), xs.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# fft and prox
# ---------------------------------------------------------------------------
def test_fft_matches_jax():
    rng = np.random.default_rng(12)
    img = rng.normal(size=(3, 33, 28)).astype(np.float32)
    kern = rng.normal(size=(3, 15, 15)).astype(np.float32)
    for helper in ("good_fft_shape", "good_fft_shape_even",
                   "minimal_even_fft_shape", "minimal_same_fft_shape"):
        kw = {} if helper.startswith("minimal") else {"axes": (1, 2)}
        assert getattr(tfft, helper)(img, kern, **kw) == \
            getattr(jfft, helper)(img, kern, **kw)
    shape = jfft.minimal_same_fft_shape(img, kern, axes=(1, 2))
    kr_t = tfft.transform(torch.from_numpy(kern), shape)
    kr_j = jfft.transform(jnp.asarray(kern), shape)
    assert_allclose(kr_t.numpy(), np.asarray(kr_j), rtol=1e-5, atol=1e-5)
    got = tfft.convolve_fft(torch.from_numpy(img), kr_t, shape)
    ref = jfft.convolve_fft(jnp.asarray(img), kr_j, shape)
    assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    got = tfft.convolve(torch.from_numpy(img), torch.from_numpy(kern),
                        return_fourier=False)
    ref = jfft.convolve(jnp.asarray(img), jnp.asarray(kern),
                        return_fourier=False)
    assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    psfs, model = graft_psfs()
    got = tfft.match_psf(torch.from_numpy(psfs), torch.from_numpy(model),
                         return_fourier=False)
    ref = jfft.match_psf(jnp.asarray(psfs), jnp.asarray(model),
                         return_fourier=False)
    assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    for odd in ((5, 7), (6, 8)):
        x = rng.normal(size=odd).astype(np.float32)
        assert_array_equal(
            tfft.zero_pad(torch.from_numpy(x), (11, 12)).numpy(),
            np.asarray(jfft.zero_pad(jnp.asarray(x), (11, 12))))
        assert_array_equal(
            tfft.centered(torch.from_numpy(x), (3, 4)).numpy(),
            np.asarray(jfft.centered(jnp.asarray(x), (3, 4))))


def test_prox_tables_and_projection_match_jax():
    for shape, center in (((21, 21), (10, 10)), ((15, 12), (6, 4))):
        w_t = tprox.monotonic_weights(shape, "angle", center)
        w_j = jprox.monotonic_weights(shape, "angle", center)
        assert_array_equal(w_t, w_j)
        assert tprox.monotonic_depth(w_t, shape, center) == \
            jprox.monotonic_depth(w_j, shape, center)
        assert_array_equal(tprox.sort_by_radius(shape, center),
                           jprox.sort_by_radius(shape, center))
        x = np.random.default_rng(13).uniform(size=shape).astype(np.float32)
        n = tprox.monotonic_depth(w_t, shape, center)
        got = tprox.prox_weighted_monotonic(torch.from_numpy(x), w_t, n, 0.0,
                                            center)
        ref = jprox.prox_weighted_monotonic(jnp.asarray(x), w_j, n, 0.0,
                                            center)
        assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    x = np.random.default_rng(14).uniform(size=(16, 13)).astype(np.float32)
    for center in ((8, 6), (5, 9), (11, 2)):
        got = tprox.prox_uncentered_symmetry(torch.from_numpy(x), 0, center,
                                             "sdss")
        ref = jprox.prox_uncentered_symmetry(jnp.asarray(x), 0, center,
                                             "sdss")
        assert_array_equal(got.numpy(), np.asarray(ref))
    # the default algorithm ("kspace" without a shift: the soft symmetry),
    # ported with the object tree
    got = tprox.prox_uncentered_symmetry(torch.from_numpy(x), 0, (8, 6))
    ref = jprox.prox_uncentered_symmetry(jnp.asarray(x), 0, (8, 6))
    assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
