"""The folded matmul-DFT convolution (``ops.fft.convolve_dft``, the fit's
``conv_mode="dft"``) and the real-space convolution mode of
``LiteObservation`` against the JAX package on the CPU.

Tolerances: the DFT matrices array for array; a convolution within
1e-5 of its largest output value (float32 roundoff of ~60-term sums);
fit losses rtol 1e-5 against the JAX fit in the same mode over 15
iterations, rtol 1e-4 between the two modes (the JAX package's own bound,
tests/test_parallel.py:234-246).

The bf16 tiers (``conv_precision`` "high"/"tensorfloat32" and
"default"/"bfloat16"/"fastest"): XLA on the CPU ignores ``precision``, so
the JAX package gives its float32 result at every tier.  Each of the four
products of a tier convolution is held to 1e-6 of its largest value
against a float64 emulation of its bf16 splits (the products are exact,
only the float32 sums differ); the whole convolution to the tier's own
error against JAX's float32 result (1e-2 at one pass, measured 4.0e-3 to
4.3e-3 of the largest value; 3e-5 at three, measured 6.7e-6 to 7.8e-6),
and beyond five times float32's (2.4e-7 to 2.7e-7 against float64: it
does not fall back to float32).  A whole chain
is not held to its emulation at 1e-6: where the port's float32
intermediate and the emulation's part by an ulp across a bf16 rounding
midpoint, the split moves by a bf16 ulp (measured 2e-6 to 7e-6 of the
largest value).  A 10-iteration fit at "high" against JAX's at rtol 1e-4
(measured 1.6e-6; 7.1e-7 at "float32", 7.5e-4 at "default").
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

import __graft_entry__ as graft
from scarlet_tpu import lite as jlite
from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.ops import fft as jfft
from scarlet_tpu_torch import convert
from scarlet_tpu_torch import lite as tlite
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.ops import fft as tfft
from scarlet_tpu_torch.testing import generate_blend

TIERS = {"default": 1, "bfloat16": 1, "fastest": 1, "high": 3,
         "tensorfloat32": 3}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(config, data, state):
    return convert.from_jax(dataclasses.asdict(config), jax.device_get(data),
                            jax.device_get(state), device="cpu")


def _close(got, ref, scale=None):
    scale = np.abs(ref).max() if scale is None else scale
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() <= 1e-5 * scale


@pytest.mark.parametrize("in_shape,fft_shape,dtype", [
    ((58, 48), (72, 60), np.float32), ((33, 28), (48, 40), np.float32),
    ((21, 21), (32, 32), np.float64), ((32, 36), (45, 54), np.float32)])
def test_dft_conv_matrices_equal_jax(in_shape, fft_shape, dtype):
    got = tfft.dft_conv_matrices(in_shape, fft_shape, dtype)
    ref = jfft.dft_conv_matrices(in_shape, fft_shape, dtype)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a.dtype == np.asarray(b).dtype
        assert_array_equal(a, np.asarray(b))
    assert tfft.dft_conv_matrices(in_shape, fft_shape, dtype) is got


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_convolve_dft_matches_jax_and_fft(lead):
    rng = np.random.default_rng(len(lead))
    img = rng.normal(size=lead + (5, 33, 28)).astype(np.float32)
    kern = rng.normal(size=(5, 15, 15)).astype(np.float32)
    shape = jfft.minimal_same_fft_shape(img.shape[-3:], kern, axes=(1, 2))
    kr_t = tfft.transform(torch.from_numpy(kern), shape)
    ops = tfft.dft_conv_operators((33, 28), shape, torch.float32, "cpu")
    got = tfft.convolve_dft(torch.from_numpy(img), kr_t, ops)
    assert got.shape == img.shape and got.dtype == torch.float32
    # the card's gradient gather reads unit column strides
    assert got.is_contiguous()
    mats = jfft.dft_conv_matrices((33, 28), shape)
    ref = np.asarray(jfft.convolve_dft(
        jnp.asarray(img), jfft.transform(jnp.asarray(kern), shape), mats),
        np.float32)
    _close(got.numpy(), ref)
    fft = tfft.convolve_fft(torch.from_numpy(img), kr_t, shape)
    _close(got.numpy(), fft.numpy())


def test_dft_operators_cached_per_device():
    a = tfft.dft_conv_operators((10, 12), (16, 20), torch.float32, "cpu")
    assert tfft.dft_conv_operators((10, 12), (16, 20), torch.float32,
                                   "cpu") is a
    assert a.A.dtype == torch.complex64 and a.iB_il.dtype == torch.float32
    assert a.A.shape == (16, 10) and a.iB_il.shape == (22, 12)
    iB = tfft.dft_conv_matrices((10, 12), (16, 20))[3]
    assert torch.equal(a.iB_il[0::2], torch.from_numpy(iB[0]))
    assert torch.equal(a.iB_il[1::2], torch.from_numpy(-iB[1]))


def _observations(mode):
    d = generate_blend(np.random.default_rng(0))
    w = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    mp = tlite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    args = (d["images"], d["variance"], w, d["psfs"])
    return (jlite.LiteObservation(*args, model_psf=mp,
                                  convolution_mode=mode),
            tlite.LiteObservation(*args, model_psf=mp,
                                  convolution_mode=mode, device="cpu"))


@pytest.mark.parametrize("grad", [False, True])
def test_real_mode_convolve_matches_jax(grad):
    jo, to = _observations("real")
    assert to.mode == "real"
    img = np.random.default_rng(3).normal(size=to.shape).astype(np.float32)
    ref = np.asarray(jo.convolve(img, grad=grad))
    got = to.convolve(torch.from_numpy(img), grad=grad)
    assert got.shape == img.shape and got.dtype == torch.float32
    _close(got.numpy(), ref)
    # the observation's mode is the default; "fft" may be asked for
    fft = to.convolve(torch.from_numpy(img), mode="fft", grad=grad)
    _close(fft.numpy(), np.asarray(jo.convolve(img, mode="fft", grad=grad)))
    _close(fft.numpy(), ref, scale=np.abs(ref).max() * 10)


def test_real_mode_band_slice_and_unknown_mode():
    jo, to = _observations("real")
    sub, jsub = to[1], jo[1]
    assert sub.mode == "real" and sub.shape == (1,) + to.shape[1:]
    assert sub.device == to.device
    img = np.random.default_rng(4).normal(size=sub.shape).astype(np.float32)
    _close(sub.convolve(torch.from_numpy(img)).numpy(),
           np.asarray(jsub.convolve(img)))
    assert to[1:3].shape == (2,) + to.shape[1:]
    with pytest.raises(ValueError, match="mode"):
        to.convolve(torch.from_numpy(img), mode="wavelet")
    with pytest.raises(ValueError, match="convolution_mode"):
        tlite.LiteObservation(*(np.zeros((1, 5, 5), np.float32),) * 3,
                              np.ones((1, 3, 3), np.float32),
                              convolution_mode="dft", device="cpu")


@pytest.mark.parametrize("accel", [False, True])
def test_fit_scan_dft_matches_jax(accel):
    """15 iterations of the demo blend under ``conv_mode="dft"`` against
    the JAX fit in the same mode (the accelerator configuration with the
    JAX kernels in interpret mode where ``accel``): losses rtol 1e-5."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(32,),
                                 conv_mode="dft")
    if accel:
        config = dataclasses.replace(
            config, use_pallas=True, use_pallas_scene=True,
            packed_morphs=True, pallas_interpret=True)
    _, loss_j = jeng.fit_scan(state, data, config, 15)
    cfg, d, s = _port(config, data, state)
    out_t, loss_t = teng.fit_scan(s, d, cfg, 15)
    assert np.isfinite(loss_t.numpy()).all()
    assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    # and the FFT fit tracks it (the JAX package's own bound)
    _, loss_f = teng.fit_scan(s, d, dataclasses.replace(cfg,
                                                        conv_mode="fft"), 15)
    assert_allclose(loss_t.numpy(), loss_f.numpy(), rtol=1e-4)


def test_render_dft_matches_fft_on_a_batch():
    """``engine.render`` of a batch of generated blends in both modes."""
    from scarlet_tpu_torch import parallel as tpar

    blends = []
    for seed in (0, 1):
        d = generate_blend(np.random.default_rng(seed))
        w = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
        obs = tlite.LiteObservation(
            d["images"], d["variance"], w, d["psfs"],
            model_psf=tlite.integrated_circular_gaussian(sigma=0.8)[None]
            .astype(np.float32), device="cpu")
        centers = [(int(round(r["y"])), int(round(r["x"])))
                   for r in d["catalog"]]
        src = tlite.parameterize_sources(
            tlite.init_all_sources_main(obs, centers), obs,
            tlite.init_adaprox_component)
        blends.append(tlite.LiteBlend(src, obs))
    cfg, data, state = tpar.pack_blends(blends)
    fft = teng.render(state, data, cfg)
    dft = teng.render(state, data, dataclasses.replace(cfg, conv_mode="dft"))
    _close(dft.numpy(), fft.numpy())


def _tier_inputs(lead=(3,)):
    rng = np.random.default_rng(11)
    img = rng.normal(size=lead + (5, 33, 28)).astype(np.float32)
    kern = rng.normal(size=(5, 15, 15)).astype(np.float32)
    shape = jfft.minimal_same_fft_shape(img.shape[-3:], kern, axes=(1, 2))
    return img, kern, shape


def _bf16(x):
    """float32 -> bfloat16 (nearest even, the JAX package's type) as
    float64."""
    return np.asarray(x, np.float32).astype(jnp.bfloat16).astype(np.float64)


def _emulated_product(a, b, passes):
    """``a @ b`` at a bf16 tier in float64: the exact products of the
    splits, summed exactly enough."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ahi, bhi = _bf16(a), _bf16(b)
    if passes == 1:
        return ahi @ bhi
    alo, blo = _bf16(a - ahi), _bf16(b - bhi)
    return ahi @ blo + alo @ bhi + ahi @ bhi


@pytest.mark.parametrize("precision", sorted(TIERS))
def test_bf16_products_match_their_emulation(precision, monkeypatch):
    """The four real products of a tier convolution, each on the operand
    the port hands it, against the float64 emulation of its bf16 splits
    with the right operand rebuilt here from the JAX package's matrices
    ([Re B | Im B], the real blocks of A^T and iA^T, [Re iB; -Im iB]):
    within 1e-6 of the product's largest value."""
    img, kern, shape = _tier_inputs()
    A, B, iA, iB = (np.asarray(m) for m in
                    jfft.dft_conv_matrices((33, 28), shape))
    rights = [np.concatenate([B[0], B[1]], 1),
              np.block([[A[0].T, A[1].T], [-A[1].T, A[0].T]]),
              np.block([[iA[0].T, iA[1].T], [-iA[1].T, iA[0].T]]),
              np.concatenate([iB[0], -iB[1]], 0)]
    calls = []
    real = tfft.bf16_matmul

    def spy(a, b, passes):
        out = real(a, b, passes)
        calls.append((a.numpy().copy(), passes, out.numpy().copy()))
        return out

    monkeypatch.setattr(tfft, "bf16_matmul", spy)
    ops = tfft.dft_conv_operators((33, 28), shape, torch.float32, "cpu",
                                  precision)
    assert isinstance(ops, tfft.DftTierOperators)
    assert ops.passes == TIERS[precision] and ops.B.dtype == torch.bfloat16
    kr = tfft.transform(torch.from_numpy(kern), shape)
    tfft.convolve_dft(torch.from_numpy(img), kr, ops)
    assert len(calls) == 4
    for (a, passes, got), right in zip(calls, rights):
        assert passes == TIERS[precision] and got.dtype == np.float32
        ref = _emulated_product(a, right, passes)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("lead", [(3,), (2, 2)])
@pytest.mark.parametrize("precision", ["default", "high"])
def test_bf16_tiers_against_jax(precision, lead):
    """A tier convolution against the JAX package's at the same precision
    (float32 on the CPU) within the tier's error, beyond float32's own
    error against float64 (no quiet float32), and each alias bit for bit
    the same as its tier's name."""
    img, kern, shape = _tier_inputs(lead)
    kr = tfft.transform(torch.from_numpy(kern), shape)
    ops = tfft.dft_conv_operators((33, 28), shape, torch.float32, "cpu",
                                  precision)
    got = tfft.convolve_dft(torch.from_numpy(img), kr, ops)
    assert got.shape == img.shape and got.dtype == torch.float32
    mats = jfft.dft_conv_matrices((33, 28), shape)
    ref = np.asarray(jfft.convolve_dft(
        jnp.asarray(img), jfft.transform(jnp.asarray(kern), shape), mats,
        precision=precision), np.float32)
    scale = np.abs(ref).max()
    err = np.abs(got.numpy() - ref).max() / scale
    assert err <= (1e-2 if precision == "default" else 3e-5)
    exact = tfft.convolve_fft(torch.from_numpy(img).double(),
                              kr.to(torch.complex128), shape).numpy()
    f32 = np.abs(ref - exact).max() / scale
    tier = np.abs(got.numpy() - exact).max() / scale
    assert f32 < 1e-6 and tier > 5 * f32
    for alias in [a for a in TIERS if TIERS[a] == TIERS[precision]]:
        other = tfft.convolve_dft(torch.from_numpy(img), kr,
                                  tfft.dft_conv_operators(
                                      (33, 28), shape, torch.float32, "cpu",
                                      alias))
        assert torch.equal(other, got)


def test_float32_precisions_keep_the_float32_route():
    """"float32" and "highest" are the complex64 route, bit for bit."""
    img, kern, shape = _tier_inputs()
    kr = tfft.transform(torch.from_numpy(kern), shape)
    ops = tfft.dft_conv_operators((33, 28), shape, torch.float32, "cpu")
    assert isinstance(ops, tfft.DftOperators)
    assert tfft.dft_conv_operators((33, 28), shape, torch.float32, "cpu",
                                   "highest") is ops
    ref = tfft.convolve_dft(torch.from_numpy(img), kr, ops)
    got = tfft.convolve_dft(torch.from_numpy(img), kr, tfft.dft_conv_operators(
        (33, 28), shape, torch.float32, "cpu", "float32"))
    assert torch.equal(got, ref)


def test_fit_scan_high_matches_jax():
    """10 iterations of the demo blend under ``conv_mode="dft"`` at
    "high" against the JAX fit at the same precision (float32 on the
    CPU): losses rtol 1e-4."""
    config, data, state = graft._demo_setup()
    config = dataclasses.replace(config, mono_n_iters=(32,),
                                 conv_mode="dft", conv_precision="high")
    _, loss_j = jeng.fit_scan(state, data, config, 10)
    cfg, d, s = _port(config, data, state)
    _, loss_t = teng.fit_scan(s, d, cfg, 10)
    assert np.isfinite(loss_t.numpy()).all()
    assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-4)


def test_unknown_precision_raises():
    config, data, state = graft._demo_setup()
    cfg, d, s = _port(config, data, state)
    bad = dataclasses.replace(cfg, conv_mode="dft", conv_precision="fp8")
    with pytest.raises(ValueError, match="conv_precision='fp8'"):
        teng.fit_step(s, d, bad)
    # read in conv_mode="dft" only, as in the JAX package
    teng.fit_step(s, d, dataclasses.replace(bad, conv_mode="fft"))
    with pytest.raises(ValueError, match="precision 'HIGH'"):
        tfft.dft_conv_operators((10, 12), (16, 20), torch.float32, "cpu",
                                "HIGH")
