"""The folded matmul-DFT convolution (``ops.fft.convolve_dft``, the fit's
``conv_mode="dft"``) and the real-space convolution mode of
``LiteObservation`` against the JAX package on the CPU.

Tolerances: the DFT matrices array for array; a convolution within
1e-5 of its largest output value (float32 roundoff of ~60-term sums);
fit losses rtol 1e-5 against the JAX fit in the same mode over 15
iterations, rtol 1e-4 between the two modes (the JAX package's own bound,
tests/test_parallel.py:234-246).
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
