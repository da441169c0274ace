"""The port's lite host layer and batched fit against the JAX package, on
generated blends (no dataset): the generator, the initialization's
decisions, ``LiteBlend.fit`` and ``pack_blends`` +
``fit_batch_device_converged``."""
import subprocess
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu import lite as jlite
from scarlet_tpu import parallel as jpar
from scarlet_tpu.testing.blendsets import generate_blend as jgen
from scarlet_tpu_torch import lite as tlite
from scarlet_tpu_torch import parallel as tpar
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.testing import generate_blend as tgen

SEEDS = (0, 1, 2)


def _blend(lite, d, noise_rms=None):
    weights = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = lite.LiteObservation(d["images"], d["variance"], weights,
                               d["psfs"], model_psf=model_psf,
                               noise_rms=noise_rms,
                               **({"device": "cpu"} if lite is tlite else {}))
    centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
               for r in d["catalog"]]
    sources = lite.init_all_sources_main(obs, centers, min_snr=50)
    sources = lite.parameterize_sources(sources, obs,
                                        lite.init_adaprox_component)
    return lite.LiteBlend(sources, obs)


def _noise_rms(d):
    # the JAX package's float32 mean drifts by ~1e-5 relative (sequential
    # sum); both sides get the same exact value so the init is compared
    # on equal inputs
    return np.sqrt(d["variance"].astype(np.float64)).mean(
        axis=(1, 2)).astype(np.float32)


def _pair(seed):
    d = tgen(np.random.default_rng(seed))
    nrms = _noise_rms(d)
    return _blend(jlite, d, nrms), _blend(tlite, d, nrms)


@pytest.mark.parametrize("seed", SEEDS + (7,))
def test_generate_blend_bitwise(seed):
    kw = dict(spergel_frac=0.5, psf_ellip=0.2, noise_corr=0.8) \
        if seed == 7 else {}
    a = jgen(np.random.default_rng(seed), **kw)
    b = tgen(np.random.default_rng(seed), **kw)
    for key in ("images", "variance", "psfs", "filters"):
        assert_array_equal(a[key], b[key])
        assert a[key].dtype == b[key].dtype
    assert a["catalog"].dtype == b["catalog"].dtype
    assert a["catalog"].tobytes() == b["catalog"].tobytes()


def test_observation_matches_jax():
    d = tgen(np.random.default_rng(0))
    jb, tb = _blend(jlite, d), _blend(tlite, d)
    jo, to = jb.observation, tb.observation
    assert_allclose(to_numpy(to.noise_rms), np.asarray(jo.noise_rms),
                    rtol=1e-5)
    assert_allclose(to_numpy(to.diff_kernel.image),
                    np.asarray(jo.diff_kernel.image), atol=1e-6)
    img = np.random.default_rng(1).normal(size=d["images"].shape).astype(
        np.float32)
    assert_allclose(to_numpy(to.convolve(torch.from_numpy(img))),
                    np.asarray(jo.convolve(img)), atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_init_all_sources_main_matches_jax(seed):
    jb, tb = _pair(seed)
    assert [len(s.components) for s in jb.sources] == \
        [len(s.components) for s in tb.sources]
    for cj, ct in zip(jb.components, tb.components):
        assert cj.bbox == ct.bbox
        assert type(cj).__name__ == type(ct).__name__
        assert_allclose(to_numpy(ct.sed), np.asarray(cj.sed), rtol=1e-5,
                        atol=1e-5)
        assert_allclose(to_numpy(ct.morph), np.asarray(cj.morph), atol=1e-5)


def test_lite_blend_fit_matches_jax():
    jb, tb = _pair(1)
    itj, lj = jb.fit(30, e_rel=1e-4)
    itt, lt = tb.fit(30, e_rel=1e-4)
    assert itt == itj
    assert len(tb.loss) == len(jb.loss) == itt
    assert_allclose(lt, lj, rtol=1e-4)
    assert np.isfinite(lt) and lt > tb.loss[0]
    # flux re-weighting ran (its per-pixel ratios are 0/0-unstable far from
    # the models, where the two FFTs leave different roundoff)
    for sj, st in zip(jb.sources, tb.sources):
        assert st.flux_box == sj.flux_box
        assert st.flux.shape == np.asarray(sj.flux).shape


def test_batched_fit_matches_jax():
    pairs = [_pair(seed) for seed in SEEDS]
    jbl, tbl = [p[0] for p in pairs], [p[1] for p in pairs]
    jcfg, jdata, jstate = jpar.pack_blends(jbl, platform="cpu")
    tcfg, tdata, tstate = tpar.pack_blends(tbl)
    assert tcfg.box_shapes == jcfg.box_shapes
    assert tcfg.bucket_counts == jcfg.bucket_counts
    assert tcfg.fft_shape == jcfg.fft_shape
    assert tcfg.scene_pad == jcfg.scene_pad
    jout, jl = jpar.fit_batch_device_converged(jstate, jdata, jcfg, 30,
                                               check_every=10)
    tout, tl = tpar.fit_batch_device_converged(tstate, tdata, tcfg, 30,
                                               check_every=10)
    assert tl.shape == tuple(np.asarray(jl).shape)
    assert_array_equal(tout.it.numpy(), np.asarray(jout.it))
    assert_allclose(tout.last_loss.numpy(), np.asarray(jout.last_loss),
                    rtol=1e-4)
    tpar.unpack_blends(tbl, tout, tl, reweight=False)
    assert [b.it for b in tbl] == tout.it.tolist()
    assert all(len(b.loss) == b.it for b in tbl)


def test_batch_converged_stops_exactly_at_cap():
    _, tb = _pair(2)
    cfg, data, state = tpar.pack_blends([tb])
    for cap, every in ((7, 3), (5, 5)):
        out, losses = tpar.fit_batch_device_converged(
            state, data, cfg, cap, check_every=every)
        assert losses.shape[0] == int(out.it[0]) <= cap


def test_import_pulls_in_no_jax():
    code = ("import sys, importlib, scarlet_tpu_torch, "
            "scarlet_tpu_torch.convert, "
            "scarlet_tpu_torch.checkpoint, scarlet_tpu_torch.detect, "
            "scarlet_tpu_torch.ops.wavelet, "
            "scarlet_tpu_torch.ops.interpolation, "
            "scarlet_tpu_torch.display, scarlet_tpu_torch.lite.display; "
            "from scarlet_tpu_torch.examples import NAMES; "
            "[importlib.import_module('scarlet_tpu_torch.examples.' + n) "
            "for n in NAMES]; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'scarlet_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
