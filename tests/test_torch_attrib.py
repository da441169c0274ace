"""The plain versions of the monotonicity-pass variants
(``scarlet_tpu_torch.ops.kernels.mono_pass_variant_plain``, the port of
the TPU tool ``tools/mono_pass_attrib.py``) on the CPU.

Each variant is held against its formula, transcribed from the TPU tool's
step functions (tools/mono_pass_attrib.py:107-136) in numpy, at S=21, K=3,
B=2.  The f32 variants run the same float32 operations in the same order
as numpy, so they agree bit for bit; bf16 rounds every product and sum
once to bf16 (nearest, ties to even), as Hopper's bf16x2 instructions do,
and agrees bit for bit too.  The Hopper
variants read each slot's own table at the pixel it weights and take
zero outside the slot, where the TPU tool's rolls read pre-shifted tables
and wrap.

``full`` at 16 forced passes is held against the JAX package's
``monotonic_prox_packed(..., interpret=True, tol_arr=-1)``, as the TPU
tool's own check does, to 1e-6 (the TPU kernel sums the 8 taps by column
groups, and XLA on the CPU fuses multiply-adds), and against the port's
production ``monotonic_prox_packed`` at ``n_iter=16, tol=0`` bit for bit.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu.ops.pallas_kernels import monotonic_prox_packed as \
    jax_packed
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.ops.prox import NEIGHBOR_OFFSETS
from scarlet_tpu_torch.tools import mono_pass_attrib as tool

S, K, B = 21, 3, 2


@pytest.fixture(scope="module")
def inputs():
    wsel, keepsel, wtab, keep = tool.slot_tables(S, K)
    packed = tool.packed_input(B, S, K)
    return packed, wsel, keepsel, wtab, keep


def _zshift(x, dy, dx):
    """out[..., y, x] = x[..., y + dy, x + dx] within each (S, S) slot,
    zero outside."""
    out = np.zeros_like(x)
    H, W = x.shape[-2:]
    ys, yd = slice(max(dy, 0), H + min(dy, 0)), slice(max(-dy, 0),
                                                      H + min(-dy, 0))
    xs, xd = slice(max(dx, 0), W + min(dx, 0)), slice(max(-dx, 0),
                                                      W + min(-dx, 0))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def _bf16(x):
    """Nearest bf16 value (8 significant bits, ties to even) of each
    value, rounded once from float64."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.round(np.ldexp(m, 8)), e - 8)


def _formula(mix, packed, wsel, keepsel, n):
    """The TPU tool's step of ``mix`` (tools/mono_pass_attrib.py:107-136),
    on (B, K, S, S) slots, for ``n`` passes."""
    x0 = packed.reshape(B, S, K, S).transpose(0, 2, 1, 3)
    w = wsel.reshape(8, S, K, S).transpose(2, 0, 1, 3)       # (K, 8, S, S)
    keep = keepsel.reshape(S, K, S).transpose(1, 0, 2) > 0.5
    h = np.float32(0.5)
    if mix == "bf16":
        # bf16 operands: products and sums are exact in float64, and each
        # is rounded once to bf16
        x0, w = _bf16(x0), _bf16(w)
    x = x0
    for _ in range(n):
        if mix == "rollsonly":
            x = ((_zshift(x, -1, 0) + _zshift(x, 1, 0) + _zshift(x, 0, -1)
                  + _zshift(x, 0, 1)) * np.float32(0.25))
        elif mix == "alu8":
            for d in range(8):
                x = x * h + w[:, d]
        else:
            ref = np.zeros_like(x)
            for d, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
                nb = x if mix in ("norolls", "bf16") else _zshift(x, dy, dx)
                t = w[:, d] * nb
                ref = _bf16(ref + _bf16(t)) if mix == "bf16" else ref + t
            x = np.where(keep, x0, np.minimum(x0, ref))
    return x.transpose(0, 2, 1, 3).reshape(packed.shape)


@pytest.mark.parametrize("mix", kn.MONO_PASS_MIXES)
def test_plain_variant_matches_formula(inputs, mix):
    packed, wsel, keepsel, _, _ = inputs
    n = 8
    got = kn.mono_pass_variant_plain(torch.from_numpy(packed),
                                     torch.from_numpy(wsel),
                                     torch.from_numpy(keepsel), mix, n)
    assert got.dtype == torch.float32 and got.shape == packed.shape
    assert_array_equal(got.numpy(), _formula(mix, packed, wsel, keepsel, n))


def test_pass_counts_round_up_to_whole_blocks(inputs):
    """A forced count runs whole blocks of the variant's unroll, as the
    kernel's loop does: 6 -> 8 passes (unroll 4), 12 -> 16 (unroll 8)."""
    packed, wsel, keepsel, _, _ = (torch.from_numpy(a) for a in inputs)
    for mix, n, ran in (("full", 6, 8), ("unroll8", 12, 16)):
        assert torch.equal(
            kn.mono_pass_variant(packed, wsel, keepsel, mix, n),
            kn.mono_pass_variant_plain(packed, wsel, keepsel, "noreduce",
                                       ran))
    with pytest.raises(ValueError, match="unknown mix"):
        kn.mono_pass_variant(packed, wsel, keepsel, "fp8", 4)


def test_full_matches_production_and_jax(inputs):
    packed, wsel, keepsel, wtab, keep = inputs
    n = tool.N_CHECK
    got = kn.mono_pass_variant(torch.from_numpy(packed),
                               torch.from_numpy(wsel),
                               torch.from_numpy(keepsel), "full", n).numpy()
    idx = torch.zeros((B, K), dtype=torch.int32)
    prod = kn.monotonic_prox_packed(torch.from_numpy(packed), idx,
                                    torch.from_numpy(wtab),
                                    torch.from_numpy(keep), S, n, tol=0.0)
    assert_array_equal(got, prod.numpy())
    never = jnp.asarray(-1.0, jnp.float32)
    ref = np.stack([np.asarray(jax_packed(
        jnp.asarray(p), jnp.zeros((K,), jnp.int32), jnp.asarray(wtab),
        jnp.asarray(keep), S, n, interpret=True, tol_arr=never))
        for p in packed])
    assert ref.dtype == np.float32
    assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # 16 passes move the input: the check is not of a fixed point
    assert np.abs(got - packed).max() > 0.1


def test_slot_tables_are_the_candidate_0_tables(inputs):
    """Each slot of the packed tables holds candidate 0's tables, as the
    TPU tool gathers them (tools/mono_pass_attrib.py:76-93), unshifted."""
    _, wsel, keepsel, wtab, keep = inputs
    for k in range(K):
        assert_array_equal(wsel[:, :, k * S:(k + 1) * S], wtab[0])
        assert_array_equal(keepsel[:, k * S:(k + 1) * S], keep[0])
    assert tool.packed_input(B, S, K).shape == (B, S, K * S)


def test_tool_needs_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--reps", "1"]) != 0
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="CUDA"):
        tool.attribute("cpu")
