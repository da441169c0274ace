"""The wide engine of the projection kernels (boxes beyond
``kernels.mono_geometry``, more than 73 pixels a side) on the CPU: its
launch geometry (``kernels.wide_geometry``: the bands of a thread-block
cluster) and the wide-box K5 and K6 wrappers, whose CPU branches run the
plain versions, against the JAX package's Pallas kernels in interpret
mode.  The CUDA kernels are held against the plain versions in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.optim import AdaproxState as JState
from scarlet_tpu.ops import pallas_kernels as pk
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.optim import AdaproxState as TState

SMS = 132                       # an H100's SMs
BOXES = [(74, 74), (81, 81), (101, 101), (128, 128), (150, 150),
         (77, 130), (130, 77)]
COUNTS = [1, 4, 32, 256]        # morphologies per launch (B * K)
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


def _fits(rows, W):
    """Whether a band of rows x W fits one CTA: its three planes in
    shared memory and its pixels in the register slots."""
    return (3 * (rows + 2) * (W + 2) * 4 <= kn.WIDE_SMEM_LIMIT
            and kn._band_slots(rows, W) is not None)


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("box", BOXES, ids=lambda b: f"{b[0]}x{b[1]}")
def test_wide_geometry_covers_the_frame(box, n):
    """Every box here is beyond the register kernels; its R bands cover
    each frame row exactly once, each with one halo row above and below
    in its CTA's planes, within a block's shared memory and the register
    slots; R is a power of two of at most 16, as many as the SMs take,
    and no more than a band's fit needs once the morphologies fill the
    SMs (1 where the box fits one block, which none of these does); the
    thread map covers its band."""
    hb, wb = box
    with pytest.raises(ValueError):
        kn.mono_geometry(hb, wb)
    g = kn.wide_geometry(n, hb, wb, SMS)
    assert g.transposed == (wb > hb)
    assert (g.H, g.W) == ((wb, hb) if wb > hb else (hb, wb))
    assert g.R in (1, 2, 4, 8, 16)
    bands = g.bands()
    assert len(bands) == g.R and bands[0][0] == 0 and bands[-1][1] == g.H
    for (a, b), (c, _) in zip(bands, bands[1:]):
        assert b == c
    sizes = [b - a for a, b in bands]
    assert min(sizes) >= 1 and max(sizes) == g.rows
    assert not g.workspace and _fits(g.rows, g.W)
    assert g.smem == 3 * (g.rows + 2) * (g.W + 2) * 4 <= kn.SMEM_LIMIT
    # as many CTAs as the SMs take, or as few as a band's fit needs
    assert n * g.R <= SMS or not _fits(-(-g.H // (g.R // 2)), g.W)
    for more in (16, 8, 4, 2):
        if more > g.R:
            assert n > SMS // more
    if n >= SMS:
        assert (g.R == 1) == _fits(g.H, g.W) is False
    assert g.P in kn.WIDE_SLOTS and g.ny * g.P >= g.rows
    limit = kn.WIDE_SLOT_THREADS[kn.WIDE_SLOTS.index(g.P)]
    assert g.W * g.ny <= g.threads <= limit and g.threads % 32 == 0


@pytest.mark.parametrize("n", COUNTS)
def test_wide_geometry_is_the_same_for_a_transposed_box(n):
    """A box wider than tall runs on its transpose: 77 x 130 and 130 x 77
    get the same frame, bands and thread map."""
    a = kn.wide_geometry(n, 77, 130, SMS)
    b = kn.wide_geometry(n, 130, 77, SMS)
    assert a.transposed and not b.transposed
    assert a._replace(transposed=False) == b


def test_wide_geometry_workspace_and_register_limits():
    """The planes leave shared memory only past what 16 CTAs hold
    (``mono_wide_workspace``); a band too large for the register slots at
    any R streams its taps, with as few CTAs as shared memory allows once
    the morphologies fill the SMs; R fills the clusters the card holds at
    once."""
    for S in (74, 128, 150, 300, 530):
        assert not kn.mono_wide_workspace(S, S)
    for S in (540, 600):
        assert kn.mono_wide_workspace(S, S)
        g = kn.wide_geometry(1, S, S, SMS)
        assert g.workspace and g.smem == 0 and g.P == 0 and g.R == 16
        assert kn.wide_geometry(SMS, S, S, SMS).R == 1
    g = kn.wide_geometry(1, 300, 300, SMS)
    assert g.P == 0 and g.threads == kn.WIDE_STREAM_THREADS and g.ny == 0
    assert kn.wide_geometry(SMS, 300, 300, SMS).R == 8    # shared memory
    assert kn.wide_geometry(1, 128, 128, SMS).P == 1
    assert kn.wide_geometry(512, 81, 81, SMS).R == 2      # register slots
    # a card that holds fewer clusters of 16 than 132 // 16 at once
    assert kn.wide_geometry(8, 128, 128, SMS).R == 16
    assert kn.wide_geometry(8, 128, 128, SMS, {16: 7}).R == 8
    assert kn.wide_geometry(7, 128, 128, SMS, {16: 7}).R == 16
    # a 9-row box is never cut into more bands than it has rows
    g = kn.wide_geometry(1, 2000, 9, SMS)
    assert g.R == 16 and min(b - a for a, b in g.bands()) >= 1


def _inputs(box, K, seed):
    """K5/K6 inputs at a wide box (tests/test_pallas_kernels.py's
    fused-kernel inputs, grown): a gated-off slot, a box mask cutting
    columns, nonzero thresholds, a peak near the center."""
    hb, wb = box
    rng = np.random.RandomState(seed)
    weights, keeps, n_iter = jeng.monotonicity_tables(box, 1, "angle")
    yy, xx = np.mgrid[:hb, :wb]
    prof = np.exp(-((yy - hb // 2) ** 2 + (xx - wb // 2) ** 2) / 200.0)
    morphs = (prof + 0.3 * rng.rand(K, hb, wb)).astype(np.float32)
    gate = np.array([True, False, True])[:K]
    bmask = np.ones((K, hb, wb), np.float32)
    bmask[min(1, K - 1), :, :5] = 0.0
    return dict(
        weights=weights.astype(np.float32), keeps=keeps.astype(np.float32),
        n_iter=n_iter, morphs=morphs,
        grads=(rng.randn(K, hb, wb) * 0.1).astype(np.float32),
        m=(rng.randn(K, hb, wb) * 0.05).astype(np.float32),
        v=(rng.rand(K, hb, wb) * 0.01).astype(np.float32),
        vhat=(rng.rand(K, hb, wb) * 0.01).astype(np.float32), gate=gate,
        bmask=bmask, thr=np.array([0.02, 0.0, 0.05], np.float32)[:K])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tol,K", [(0.0, 3), (1e-3, 1)])
@pytest.mark.parametrize("box", [(77, 77), (75, 90)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_wide_prox_chain_matches_packed_chain_kernel(box, tol, K):
    """K5 at a box beyond ``mono_geometry`` against
    ``monotonic_prox_packed_chain`` in interpret mode, to test_torch_fused's
    bound at box 21 (rtol 1e-6, atol 1e-7: the Pallas kernel's own
    association of the taps and the max normalization differ from the
    plain version's by an ulp, 3.5e-7 relative at most here); at tol > 0
    with one slot (the TPU kernel exits per packed group)."""
    d = _inputs(box, K, 3)
    hb, wb = box
    stepped = d["morphs"] * d["bmask"]
    c, cx = hb // 2, wb // 2
    idx = np.argmax(stepped[:, c - 1:c + 2, cx - 1:cx + 2].reshape(K, 9),
                    axis=1).astype(np.int32)

    def pack(x):
        return np.ascontiguousarray(np.swapaxes(x, 0, 1).reshape(hb, K * wb))

    ref = np.asarray(pk.monotonic_prox_packed_chain(
        jnp.asarray(pack(d["morphs"] + 7.0)), jnp.asarray(pack(stepped)),
        jnp.asarray(idx), jnp.asarray(d["weights"]), jnp.asarray(d["keeps"]),
        jnp.asarray(np.repeat(d["thr"], wb)),
        jnp.asarray(np.repeat(d["gate"].astype(np.float32), wb)), wb,
        d["n_iter"], 0.0, FLOOR, interpret=True, tol=tol))
    before = kn.launch_counts()
    got = kn.prox_chain(_t(d["morphs"] + 7.0), _t(stepped), _t(idx),
                        _t(d["weights"]), _t(d["keeps"]), _t(d["thr"]),
                        _t(d["gate"]), d["n_iter"], 0.0, FLOOR, tol=tol)
    assert kn.launch_counts() == before          # the CPU runs no kernel
    assert_allclose(pack(got.numpy()), ref, rtol=1e-6, atol=1e-7)
    off = ~d["gate"]
    assert_array_equal(got.numpy()[off], (d["morphs"] + 7.0)[off])


@pytest.mark.parametrize("it", [0, 3])
@pytest.mark.parametrize("box", [(77, 77), (75, 90)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_wide_fused_morph_update_matches_pallas(box, it):
    """K6 at a box beyond ``mono_geometry`` against the JAX package's
    ``fused_morph_update`` in interpret mode: the morphologies to K5's
    bound (rtol 1e-6, atol 1e-7); each moment within one float32 ulp of
    the sum of its two terms' magnitudes (``c1 g + b1 m``,
    ``c2 g^2 + b2 v``): XLA's CPU code may fuse a product into the sum
    (one rounding fewer), the port rounds each product as its kernel does,
    and at this size cancellation leaves results ~1e-5 apart relative
    (1.5e-8 absolute); gated-off slots keep their inputs exactly."""
    d = _inputs(box, 3, 4)
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
    g = d["grads"].astype(np.float64)
    ulp = np.float64(2.0 ** -23)
    bound_m = ulp * (np.abs((1 - B1) * g) + np.abs(B1 * d["m"]))
    bound_v = ulp * (np.abs((1 - B2) * g * g) + np.abs(B2 * d["v"]))
    for a, b, bound in zip(got_opt, ref_opt, (bound_m, bound_v, bound_v)):
        diff = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64))
        assert (diff <= bound).all(), float((diff / bound).max())
    off = ~d["gate"]
    assert_array_equal(got_x.numpy()[off], d["morphs"][off])
    assert_array_equal(got_opt.vhat.numpy()[off], d["vhat"][off])
