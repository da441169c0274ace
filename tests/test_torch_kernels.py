"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``scarlet_tpu_torch.ops.kernels`` runs its
plain PyTorch version; here those are held against the TPU kernels run in
interpret mode (and the JAX engine's XLA branch), on the same numpy
inputs, to atol/rtol 1e-6.  The CUDA kernels are held against the plain
versions on the card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.ops import pallas_kernels as pk
from scarlet_tpu.ops import prox as jprox
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.ops import kernels as kn

TOL = dict(rtol=1e-6, atol=1e-6)
BOX = 21


def _tables(box=BOX):
    w, keep, n_iter = teng.monotonicity_tables((box, box), 1, "angle")
    return w.astype(np.float32), keep.astype(np.float32), n_iter


def _morphs(rng, K, box=BOX):
    """Noisy peaked profiles, with an exact plateau (equal neighbors) and
    an argmax tie in the first morph's 3x3 center window."""
    yy, xx = np.mgrid[:box, :box] - box // 2
    scale = rng.uniform(2, 30, (K, 1, 1))
    m = np.exp(-(yy ** 2 + xx ** 2) / scale) * (
        1 + 0.3 * rng.uniform(size=(K, box, box)))
    c = box // 2
    m[0, c - 1:c + 2, c - 1:c + 2] = 1.5
    return m.astype(np.float32)


def _idx(morphs):
    c = morphs.shape[-1] // 2
    win = morphs[..., c - 1:c + 2, c - 1:c + 2]
    return np.argmax(win.reshape(*win.shape[:-2], 9), axis=-1).astype(
        np.int32)


def test_candidate_argmax_tie_takes_first():
    m = _morphs(np.random.default_rng(0), 3)
    t = torch.from_numpy(m)
    c = BOX // 2
    win = t[..., c - 1:c + 2, c - 1:c + 2].reshape(3, 9)
    assert int(win.argmax(-1)[0]) == 0
    assert_array_equal(win.argmax(-1).numpy(), _idx(m))
    assert_array_equal(
        win.argmax(-1).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(m[:, c - 1:c + 2, c - 1:c + 2])
                              .reshape(3, 9), axis=1)))


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_monotonic_prox_matches_batched_monotonic_prox(tol):
    rng = np.random.default_rng(1)
    w, keep, n_iter = _tables()
    K = 6
    m = _morphs(rng, K)
    idx = _idx(m)
    # the TPU kernel exits per group of lane-packed morphologies, the
    # port per morphology: at tol > 0 they agree with a group of one
    group = None if tol == 0.0 else 1
    ref = np.asarray(pk.batched_monotonic_prox(
        jnp.asarray(m), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(keep),
        n_iter, 0.0, interpret=True, group=group, tol=tol))
    got = kn.monotonic_prox(torch.from_numpy(m), torch.from_numpy(idx),
                            torch.from_numpy(w), torch.from_numpy(keep),
                            n_iter, 0.0, tol=tol)
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("tol,K", [(0.0, 5), (1e-3, 1)])
def test_monotonic_prox_packed_matches(tol, K):
    """Packed layout; at tol > 0 with one slot (the TPU kernel's exit is
    per packed group)."""
    rng = np.random.default_rng(2)
    w, keep, n_iter = _tables()
    m = _morphs(rng, K)
    idx = _idx(m)
    packed = np.ascontiguousarray(
        np.swapaxes(m, 0, 1).reshape(BOX, K * BOX))
    ref = np.asarray(pk.monotonic_prox_packed(
        jnp.asarray(packed), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(keep), BOX, n_iter, 0.0, interpret=True, tol=tol))
    got = kn.monotonic_prox_packed(
        torch.from_numpy(packed), torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(keep), BOX, n_iter, 0.0, tol=tol)
    assert_allclose(got.numpy(), ref, **TOL)


def test_monotonic_prox_exact_equals_depth_passes():
    """At tol 0 the block exit is the exact fixed point: the JAX XLA
    branch's n_iter plain passes, per slice."""
    rng = np.random.default_rng(3)
    w, keep, n_iter = _tables()
    m = _morphs(rng, 4)
    idx = _idx(m)
    got = kn.monotonic_prox(torch.from_numpy(m[None]),
                            torch.from_numpy(idx[None]),
                            torch.from_numpy(w), torch.from_numpy(keep),
                            n_iter).numpy()[0]
    for k in range(4):
        cy = BOX // 2 + idx[k] // 3 - 1
        cx = BOX // 2 + idx[k] % 3 - 1
        ref = np.asarray(jprox.prox_weighted_monotonic(
            jnp.asarray(m[k]), jnp.asarray(w[idx[k]]), n_iter,
            min_gradient=0.0, center=(cy, cx)))
        assert_allclose(got[k], ref, **TOL)


def _bucket(rng, B=2, C=5, H=58, W=48, K=10, hb=BOX, pad=8):
    """Random components whose boxes reach up to pad-1 pixels past every
    scene edge (negative origins included)."""
    seds = rng.uniform(0.1, 2, (B, K, C)).astype(np.float32)
    morphs = rng.uniform(0, 1, (B, K, hb, hb)).astype(np.float32)
    oy = rng.integers(1 - pad, H - hb + pad, (B, K, 1))
    ox = rng.integers(1 - pad, W - hb + pad, (B, K, 1))
    origins = np.concatenate([oy, ox], -1).astype(np.int32)
    on = rng.uniform(size=(B, K)) > 0.2
    assert origins.min() < 0
    return seds, morphs, origins, on


def test_scene_assembly_matches_pallas():
    rng = np.random.default_rng(4)
    C, H, W, pad = 5, 58, 48, 8
    seds, morphs, origins, on = _bucket(rng, pad=pad)
    got = kn.scene_assembly(*map(torch.from_numpy, (seds, morphs, origins,
                                                    on)), (C, H, W), pad)
    assert got.shape == (2, C, H, W)
    cfg = jeng.LiteFitConfig(scene_shape=(C, H, W), box_shapes=((BOX, BOX),),
                             bucket_counts=(10,), fft_shape=None,
                             mono_n_iters=(32,), scene_pad=pad)
    for b in range(2):
        ref = np.asarray(pk.scene_assembly(
            jnp.asarray(seds[b]), jnp.asarray(morphs[b]),
            jnp.asarray(origins[b]), jnp.asarray(on[b]), (C, H, W), pad,
            interpret=True))
        assert_allclose(got[b].numpy(), ref, **TOL)
        state = jeng.make_blend_state(seds[b], morphs[b], origins[b],
                                      comp_active=on[b])
        xla = np.asarray(jeng.make_scene(state, cfg))
        assert_allclose(got[b].numpy(), xla, **TOL)


def test_grad_gather_matches_pallas():
    rng = np.random.default_rng(5)
    C, H, W, P = 5, 58, 48, 8
    seds, morphs, origins, _ = _bucket(rng, pad=P)
    grad = rng.normal(size=(2, C, H, W)).astype(np.float32)
    gpad = np.pad(grad, ((0, 0), (0, 0), (P, P), (P, P)))
    gs, gm = kn.grad_gather(*map(torch.from_numpy, (gpad, seds, morphs,
                                                    origins)), P)
    # g_sed sums hb*wb products: its roundoff scales with sum |g * morph|
    scale = kn.grad_gather(*map(torch.from_numpy, (np.abs(gpad), seds,
                                                   morphs, origins)), P)[0]
    for b in range(2):
        rs, rm = (np.asarray(x) for x in pk.grad_gather(
            jnp.asarray(gpad[b]), jnp.asarray(seds[b]),
            jnp.asarray(morphs[b]), jnp.asarray(origins[b]), P,
            interpret=True))
        assert_allclose(gm[b].numpy(), rm, **TOL)
        assert np.all(np.abs(gs[b].numpy() - rs)
                      <= 1e-6 * scale[b].numpy() + 1e-6)


def test_plain_versions_refuse_too_small_padding():
    rng = np.random.default_rng(6)
    seds, morphs, origins, on = _bucket(rng, pad=8)
    t = [torch.from_numpy(x) for x in (seds, morphs, origins, on)]
    with pytest.raises(ValueError, match="padding"):
        kn.scene_assembly(*t, (5, 58, 48), 2)
