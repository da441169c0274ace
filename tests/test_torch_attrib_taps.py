"""The host side of the pass attribution's kernel
(``scarlet_tpu_torch.ops.kernels.mono_pass_variant``, csrc/attrib.cu), on
the CPU: the taps the wrapper builds from the TPU tool's slot tables
(``mono_pass_variant_taps``) carry each mix's plain result.

The kernel runs K1's pass engine on those taps, so K1's arithmetic on
them (``monotonic_prox_taps_plain``, at tol 0: a morphology stops only
after a block that changed nothing, after which every pass is a no-op)
must give ``mono_pass_variant_plain(..., "full")`` bit for bit, and so
must each other mix's pass written on the taps.  A slot table without
exactly one keep pixel raises ValueError (the kernel keeps one pixel a
slot, as K1 does).  The kernel itself is held against the plain versions
on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.ops.prox import NEIGHBOR_OFFSETS, shift_zero
from scarlet_tpu_torch.tools import mono_pass_attrib as tool

K, B = 3, 2
BOXES = (21, 41, 59, 69)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    """box -> (packed, wsel, keepsel) tensors of the tool's kind: K slots
    of candidate 0's tables, ``RandomState(0)`` morphologies."""
    out = {}
    for box in BOXES:
        wsel, keepsel, _, _ = tool.slot_tables(box, K)
        out[box] = tuple(torch.from_numpy(a) for a in (
            tool.packed_input(B, box, K), wsel, keepsel))
    return out


def _slots(t, box):
    return t.reshape(*t.shape[:-1], K, box).movedim(-2, -3)


def _unslots(x):
    return x.movedim(-3, -2).reshape(*x.shape[:-3], x.shape[-2], -1)


def _on_taps(mix, x0, taps, n):
    """``n`` passes of ``mix`` written on the slots' taps (slot k reads
    candidate k), as the kernel computes them; bf16 rounds each product
    and sum once to bf16, as ``mono_pass_variant_plain`` does."""
    box = x0.shape[-1]
    w = torch.from_numpy(taps.weights)                    # (K, hb, hb, T)
    codes = torch.from_numpy(taps.codes).long()
    count = codes & 15
    dirs = [(codes >> (4 + 3 * t)) & 7 for t in range(taps.T)]
    keep = torch.arange(box * box).reshape(box, box) \
        == torch.from_numpy(taps.centers).long()[:, None, None]
    if mix == "bf16":
        x0, w = kn._round_bf16(x0.double()), kn._round_bf16(w.double())
    x = x0
    for _ in range(n):
        if mix == "alu8":
            for t in range(taps.T):
                x = x * 0.5 + w[..., t]
            continue
        nb = torch.stack([shift_zero(x, dy, dx)
                          for dy, dx in NEIGHBOR_OFFSETS], dim=-1)
        ref = torch.zeros_like(x)
        for t, d in enumerate(dirs):
            own = mix in ("norolls", "bf16")
            prod = w[..., t] * (x if own else nb.gather(
                -1, d.expand_as(x)[..., None])[..., 0])
            new = kn._round_bf16(ref + kn._round_bf16(prod)) \
                if mix == "bf16" else ref + prod
            ref = torch.where(t < count, new, ref)
        x = torch.where(keep, x0, torch.minimum(x0, ref))
    return x.float()


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("box", BOXES)
def test_k1_on_the_slot_taps_is_full(inputs, box, n):
    packed, wsel, keepsel = inputs[box]
    taps = kn.mono_pass_variant_taps(wsel.numpy(), keepsel.numpy(), "full")
    assert taps.T == 4 and taps.weights.shape == (K, box, box, 4)
    idx = torch.arange(K).expand(B, K)
    got = kn.monotonic_prox_taps_plain(_slots(packed, box), idx, taps, n,
                                       tol=0.0)
    ref = kn.mono_pass_variant_plain(packed, wsel, keepsel, "full", n)
    assert_array_equal(_unslots(got).numpy(), ref.numpy())
    # the passes move the input: not a fixed point
    assert float((ref - packed).abs().max()) > 0.1


@pytest.mark.parametrize("mix", ["full", "noreduce", "unroll8", "norolls",
                                 "alu8", "bf16"])
@pytest.mark.parametrize("box", [21, 59])
def test_each_mix_on_its_taps_is_its_plain_version(inputs, box, mix):
    packed, wsel, keepsel = inputs[box]
    taps = kn.mono_pass_variant_taps(wsel.numpy(), keepsel.numpy(), mix)
    n = 8
    got = _on_taps(mix, _slots(packed, box), taps, n)
    ref = kn.mono_pass_variant_plain(packed, wsel, keepsel, mix, n)
    assert_array_equal(_unslots(got).numpy(), ref.numpy())


def test_alu8_reads_every_weight():
    """alu8 chains all 8 weights of a pixel, zeros included: T = 8, the
    directions 0..7 in order, the weights those of the slot's table."""
    wsel, keepsel, wtab, _ = tool.slot_tables(21, K)
    taps = kn.mono_pass_variant_taps(wsel, keepsel, "alu8")
    assert taps.T == 8 and (taps.codes & 15 == 8).all()
    for t in range(8):
        assert ((taps.codes >> (4 + 3 * t)) & 7 == t).all()
    for k in range(K):
        assert_array_equal(np.moveaxis(taps.weights[k], -1, 0), wtab[0])
    assert (wtab[0] == 0).any()      # the compact taps would drop these


@pytest.mark.parametrize("keeps", [0, 2])
def test_a_slot_without_one_keep_pixel_raises(keeps):
    wsel, keepsel, _, _ = tool.slot_tables(21, K)
    keepsel = keepsel.copy()
    keepsel[:, 21:42] = 0.0
    if keeps == 2:
        keepsel[3, 21 + 4] = keepsel[10, 21 + 10] = 1.0
    for mix in kn.MONO_PASS_MIXES:
        with pytest.raises(ValueError, match="one pixel a slot"):
            kn.mono_pass_variant_taps(wsel, keepsel, mix)
    with pytest.raises(ValueError, match="unknown mix"):
        kn.mono_pass_variant_taps(wsel, tool.slot_tables(21, K)[1], "fp8")


def test_taps_built_once_per_table_tensor(inputs):
    """The wrapper's taps are cached per table tensor and mix kind, laid
    out in C order, and built anew once a table is written to."""
    _, wsel, keepsel = inputs[21]
    wsel, keepsel = wsel.clone(), keepsel.clone()
    make = kn._variant_maker("full")
    first = kn._device_taps(wsel, keepsel, make)
    assert kn._device_taps(wsel, keepsel, make) is first
    # the kernel reads them as contiguous arrays (the slots' tables are
    # views of the packed ones, whose layout numpy's results can keep)
    assert all(t.is_contiguous() for t in first[:3])
    dense = kn._device_taps(wsel, keepsel, kn._variant_maker("alu8"))
    assert dense.T == 8 and first.T == 4
    wsel[:, 0, 0] += 1.0
    again = kn._device_taps(wsel, keepsel, make)
    assert again is not first
    assert float(again.weights[0, 0, 0].sum()) > float(
        first.weights[0, 0, 0].sum())


@pytest.mark.parametrize("counts", [tool.COUNTS, tool.K1_COUNTS])
def test_line_recovers_a_slope_per_pass_and_blend(counts):
    """The tools' least-squares line: times that grow by ``tau`` ms a
    pass over ``tool.B`` blends read ``tau / B`` ms a pass and blend."""
    tau, ovh = 0.0085, 0.075
    line = tool._line(counts, [ovh + tau * n for n in counts])
    assert line["us_per_pass_per_blend"] == pytest.approx(
        tau / tool.B * 1e3, rel=1e-9)
    assert line["overhead_us_per_blend"] == pytest.approx(
        ovh / tool.B * 1e3, rel=1e-9)
    assert line["r2"] == pytest.approx(1.0)
    assert list(line["ms_at_counts"]) == [str(n) for n in counts]


def test_shared_card_tool_needs_a_cuda_device(monkeypatch, capsys):
    from scarlet_tpu_torch.tools import shared_card

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert shared_card.main(["--rounds", "1"]) != 0
    assert capsys.readouterr().out == ""
