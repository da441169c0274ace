"""The monotonicity projection with one exit tolerance per blend (the TPU
kernel's ``tol_arr`` mode) and the engine's scheduled tolerance
(``mono_tol_early`` / ``mono_tol_switch`` / ``mono_every``), against the
JAX package on the CPU.

Tolerances: the plain projection against the JAX kernel in interpret mode
to 1e-6 (as tests/test_torch_kernels.py holds it: the TPU kernel sums a
pass's taps by column offset, ``S_0 + roll(S_-1) + roll(S_+1)``, the port
in direction order, so the two differ by float32 roundoff; the exit
decisions are the same, which the tolerances' results, apart by far more,
show), with a group of one (the TPU kernel exits per group of lane-packed
morphologies, the port per morphology, and the two agree at tol > 0 only
for a group of one); the port's plain projection with a tensor filled with
the static tolerance bit for bit; the schedule's values exactly (as
float32); the scheduled fit against its own exact fit and the JAX fit
within 1e-3 of the final logL (a looser tolerance moves the projection by
up to it, and the JAX fit exits per group); the convergence rules
exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

import __graft_entry__ as graft
from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.ops import pallas_kernels as jpk
from scarlet_tpu_torch import convert
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.parallel import batch as tbatch

TOL = dict(rtol=1e-6, atol=1e-6)


def _port(config, data, state):
    return convert.from_jax(dataclasses.asdict(config), jax.device_get(data),
                            jax.device_get(state), device="cpu")


def _morphs(B, K, box, seed):
    """Peaked, noisy morphologies (B, K, box, box) and their candidate
    tables: the projection has work to do at every tolerance."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:box, :box] - box // 2
    prof = np.exp(-np.hypot(yy, xx) / 3.0)
    x = (prof * rng.uniform(0.5, 1.5, (B, K, box, box))
         + 0.3 * rng.uniform(size=(B, K, box, box))).astype(np.float32)
    w, keep, depth = teng.monotonicity_tables((box, box), 1, "angle")
    c = box // 2
    idx = x[..., c - 1:c + 2, c - 1:c + 2].reshape(B, K, 9).argmax(-1)
    return x, idx.astype(np.int32), w.astype(np.float32), \
        keep.astype(np.float32), depth


@pytest.mark.parametrize("box", [15, 21])
def test_plain_k1_per_blend_tol_matches_jax_kernel(box):
    """The plain K1 with one tolerance per blend equals the JAX kernel
    (interpret mode, group 1, ``tol_arr``) blend by blend at 0, 1e-3 and
    1e6, to 1e-6 (the order of a pass's sum, module docstring)."""
    tols = np.array([0.0, 1e-3, 1e6, 1e-3], np.float32)
    x, idx, w, keep, depth = _morphs(len(tols), 3, box, seed=box)
    got = kn.monotonic_prox(torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(w), torch.from_numpy(keep),
                            depth, tol=torch.from_numpy(tols))
    for b, tol in enumerate(tols):
        ref = jpk.batched_monotonic_prox(
            jnp.asarray(x[b]), jnp.asarray(idx[b]), jnp.asarray(w),
            jnp.asarray(keep), depth, interpret=True, group=1,
            tol_arr=jnp.asarray(tol))
        assert_allclose(got[b].numpy(), np.asarray(ref, np.float32), **TOL)
    # the same blend at the three tolerances: each result far apart from
    # the others (beyond TOL), so the comparison above holds the exits
    same = torch.from_numpy(np.repeat(x[:1], 3, axis=0))
    three = kn.monotonic_prox(same, torch.from_numpy(idx[:1].repeat(3, 0)),
                              torch.from_numpy(w), torch.from_numpy(keep),
                              depth, tol=torch.from_numpy(tols[:3]))
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert float((three[a] - three[b]).abs().max()) > 1e-4


def test_plain_k2_per_blend_tol_matches_jax_kernel():
    """The packed layout with one tolerance per blend against the JAX
    packed kernel (one group of all slots) at the group-independent
    tolerances: 0 (the fixed point) and 1e6 (one block)."""
    box, K = 15, 3
    tols = np.array([0.0, 1e6], np.float32)
    x, idx, w, keep, depth = _morphs(len(tols), K, box, seed=5)
    packed = np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(len(tols), box, K * box))
    got = kn.monotonic_prox_packed(
        torch.from_numpy(packed), torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(keep), box, depth, tol=torch.from_numpy(tols))
    for b, tol in enumerate(tols):
        ref = jpk.monotonic_prox_packed(
            jnp.asarray(packed[b]), jnp.asarray(idx[b]), jnp.asarray(w),
            jnp.asarray(keep), box, depth, interpret=True,
            tol_arr=jnp.asarray(tol))
        assert_allclose(got[b].numpy(), np.asarray(ref, np.float32), **TOL)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_tensor_tol_filled_with_the_static_one_gives_its_bits(tol):
    x, idx, w, keep, depth = _morphs(3, 4, 15, seed=7)
    args = (torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w),
            torch.from_numpy(keep), depth)
    static = kn.monotonic_prox(*args, tol=tol)
    tensor = kn.monotonic_prox(*args, tol=torch.full((3,), tol))
    assert torch.equal(static, tensor)
    one = kn.monotonic_prox(args[0][0], args[1][0], *args[2:],
                            tol=torch.tensor(tol))
    assert torch.equal(one, static[0])
    with pytest.raises(ValueError, match="one value per blend"):
        kn.monotonic_prox(*args, tol=torch.full((4,), tol))
    with pytest.raises(TypeError, match="float32"):
        kn.monotonic_prox(*args, tol=torch.full((3,), tol,
                                                dtype=torch.float64))


SCHEDULES = [dict(mono_tol_early=1e-2, mono_tol_switch=5),
             dict(mono_tol_early=1e-2, mono_tol_switch=5, mono_tol=1e-3),
             dict(mono_every=3),
             dict(mono_tol_early=1e-2, mono_tol_switch=4, mono_every=2),
             # early not looser than the late tolerance: no schedule
             dict(mono_tol_early=1e-3, mono_tol_switch=5, mono_tol=1e-3),
             dict()]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_mono_tol_arr_matches_jax(kw):
    config, _, _ = graft._demo_setup()
    config = dataclasses.replace(config, **kw)
    cfg = teng.LiteFitConfig(**dataclasses.asdict(config))
    its = np.arange(12, dtype=np.int32)
    got = teng._mono_tol_arr(cfg, torch.from_numpy(its))
    ref = jeng._mono_tol_arr(config, jnp.asarray(its))
    if ref is None:
        assert got is None
        return
    assert got.dtype == torch.float32 and got.shape == (12,)
    assert_array_equal(got.numpy(), np.asarray(ref).astype(np.float32))


def _one_component():
    """The demo blend cut to one component: the TPU kernel's group of
    lane-packed morphologies is then one morphology, and its exits at
    tol > 0 are the port's."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, bucket_counts=(1,),
                                 mono_n_iters=(32,))
    state = jeng.make_blend_state(
        np.asarray(state.seds[0][:1]), np.asarray(state.morphs[0][:1]),
        np.asarray(state.origins[0][:1]))
    return config, data, state


ACCEL = dict(use_pallas=True, use_pallas_scene=True, packed_morphs=True,
             pallas_interpret=True)


@pytest.mark.parametrize("kw", SCHEDULES[:4])
def test_scheduled_fit_matches_jax_at_one_component(kw):
    """With one component the scheduled fit (the accelerator branch, the
    JAX kernel in interpret mode) equals JAX's to float32 roundoff: the
    same exits at the early, late and skip tolerances."""
    config, data, state = _one_component()
    config = dataclasses.replace(config, **ACCEL, **kw)
    out_j, loss_j = jeng.fit_scan(state, data, config, 12)
    cfg, d, s = _port(config, data, state)
    out_t, loss_t = teng.fit_scan(s, d, cfg, 12)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-5)
    np.testing.assert_allclose(out_t.morphs[0].numpy(),
                               np.asarray(out_j.morphs[0]), atol=1e-5)


def test_scheduled_fit_close_to_exact_and_to_jax():
    """The scheduled tolerance on the accelerator configuration, two
    components: the final logL within 1e-3 (relative) of the port's exact
    fit and of the JAX scheduled fit (which exits per group of both
    components)."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(32,), **ACCEL,
                                 mono_tol_early=1e-2, mono_tol_switch=5)
    out_j, loss_j = jeng.fit_scan(state, data, config, 10)
    cfg, d, s = _port(config, data, state)
    _, sched = teng.fit_scan(s, d, cfg, 10)
    _, exact = teng.fit_scan(s, d, dataclasses.replace(
        cfg, mono_tol_early=0.0, mono_tol_switch=0), 10)
    assert np.isfinite(sched.numpy()).all()
    for ref in (float(exact[-1]), float(loss_j[-1])):
        assert abs(float(sched[-1]) - ref) < 1e-3 * abs(ref)


def test_plain_branch_ignores_the_schedule():
    """Without ``use_pallas`` the JAX engine runs the plain projection
    for its ``n_iter`` passes whatever the schedule: so does the port (tol
    0), and the fit equals the unscheduled one."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(32,),
                                 mono_tol_early=1e-2, mono_tol_switch=5,
                                 mono_every=2)
    cfg, d, s = _port(config, data, state)
    out, losses = teng.fit_scan(s, d, cfg, 8)
    out0, losses0 = teng.fit_scan(s, d, dataclasses.replace(
        cfg, mono_tol_early=0.0, mono_tol_switch=0, mono_every=1), 8)
    assert torch.equal(losses, losses0)
    assert torch.equal(out.morphs[0], out0.morphs[0])
    _, loss_j = jeng.fit_scan(state, data, config, 8)
    np.testing.assert_allclose(losses.numpy(), np.asarray(loss_j),
                               rtol=1e-6)


@pytest.mark.parametrize("kw,frozen_ok", [
    (dict(mono_tol_early=1e-2, mono_tol_switch=6),
     lambda it: it - 1 > 6),
    (dict(mono_every=3), lambda it: (it - 1) % 3 == 0),
    (dict(mono_tol_early=1e-2, mono_tol_switch=5, mono_every=2),
     lambda it: it - 1 > 5 and (it - 1) % 2 == 0)])
def test_schedule_convergence_rules(kw, frozen_ok):
    """A batch whose blends would all freeze at ``it`` 2, the first
    iteration past ``min_iter`` (e_rel 0.5): under the schedule no blend freezes before the switch,
    and with ``mono_every`` only on an iteration ``it % mono_every == 0``
    (a blend frozen at ``it`` ends with ``it + 1`` iterations).  The
    iteration counts equal the JAX fit's."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(32,), e_rel=0.5,
                                 **kw)
    cfg, d, s = _port(config, data, state)
    images = d.images * torch.tensor([1.0, 1.3, 0.7])[:, None, None, None]
    bd, bs = tbatch.pack_batch([(d._replace(images=im), s) for im in images])
    out, _ = teng.fit_scan(bs, bd, cfg, 14)
    assert not out.active.any()
    for it in out.it.tolist():
        assert frozen_ok(it), (kw, it)
    base, _ = teng.fit_scan(bs, bd, dataclasses.replace(
        cfg, mono_tol_early=0.0, mono_tol_switch=0, mono_every=1), 14)
    assert base.it.tolist() == [3, 3, 3]
    out_j, _ = jeng.fit_scan(state, data, config, 14)
    assert int(out_j.it) == int(out.it[0])
