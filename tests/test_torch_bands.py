"""Fits that the port's gather kernels (K3 ``scene_assembly``, K4
``grad_gather``) run past 8 bands, and that the prox-chain kernels (K5
``prox_chain``, K6 ``fused_morph_update``) run on boxes past 73 pixels,
against the JAX package on the CPU, on the same numpy inputs.  On the CPU
the wrappers run their plain versions; on the card the kernels are held
against those in tests/test_torch_cuda.py and chip_smoke.py.

- a batched lite fit of 10-band generated blends (``pack_blends`` +
  ``fit_batch_device_converged``): iterations equal, final logL rtol
  1e-4, as tests/test_torch_lite.py holds the 5-band fit;
- the engine's fit at box 81 under ``packed_prox_chain`` and
  ``fuse_morph`` (the JAX kernels in interpret mode): losses rtol 1e-5,
  seds and morphs 1e-5, as tests/test_torch_fused.py holds box 21;
- ``MultiResFitter`` on a 6 + 4-channel pair (``make_pair(bands=(6,
  4))``, the JAX observations built from the same arrays): losses rtol
  1e-4, seds and morphs within 1e-4 of their largest value, iterations
  equal, as tests/test_torch_multires.py holds the 1 + 1-channel pair.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import __graft_entry__ as graft
import scarlet_tpu as st
from scarlet_tpu import lite as jlite
from scarlet_tpu import parallel as jpar
from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.parallel import multires as jmr
from scarlet_tpu.utils import make_tan_wcs as jwcs
from scarlet_tpu_torch import convert
from scarlet_tpu_torch import lite as tlite
from scarlet_tpu_torch import models as tm
from scarlet_tpu_torch import parallel as tpar
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.parallel import multires as tmr
from scarlet_tpu_torch.testing import blob_centers, generate_blend, \
    make_pair
from scarlet_tpu_torch.testing.multires import (
    SIGMA_PSF_HR, SIGMA_PSF_LR, gaussian_image)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The lite batched fit at 10 bands
# ---------------------------------------------------------------------------
def _lite_blend(lite, d, noise_rms):
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


def test_lite_batched_fit_at_ten_bands_matches_jax():
    """Two generated (10, 40, 40) blends of 4 sources, packed and fitted
    15 iterations in both packages (the JAX noise level handed to both,
    as tests/test_torch_lite.py does): the packed shapes, the iterations
    and the final logL (rtol 1e-4) agree.  On the CPU both packages pack
    for their plain scene and gradient; the card runs K3 and K4 on the
    same packing (chip_smoke.py)."""
    jbl, tbl = [], []
    for seed in (0, 1):
        d = generate_blend(np.random.default_rng(seed), shape=(10, 40, 40),
                           n_sources=4)
        nrms = np.sqrt(d["variance"].astype(np.float64)).mean(
            axis=(1, 2)).astype(np.float32)
        jbl.append(_lite_blend(jlite, d, nrms))
        tbl.append(_lite_blend(tlite, d, nrms))
    jcfg, jdata, jstate = jpar.pack_blends(jbl, platform="cpu")
    tcfg, tdata, tstate = tpar.pack_blends(tbl)
    assert tcfg.scene_shape[0] == 10
    assert tcfg.box_shapes == jcfg.box_shapes
    assert tcfg.bucket_counts == jcfg.bucket_counts
    jout, jl = jpar.fit_batch_device_converged(jstate, jdata, jcfg, 15,
                                               check_every=5)
    tout, tl = tpar.fit_batch_device_converged(tstate, tdata, tcfg, 15,
                                               check_every=5)
    assert_array_equal(tout.it.numpy(), np.asarray(jout.it))
    assert_allclose(tout.last_loss.numpy(), np.asarray(jout.last_loss),
                    rtol=1e-4)
    assert np.isfinite(tout.last_loss.numpy()).all()


# ---------------------------------------------------------------------------
# The engine's K5 and K6 configurations at box 81
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [
    dict(use_pallas_scene=True, packed_morphs=True, packed_prox_chain=True),
    dict(fuse_morph=True)], ids=["packed_prox_chain", "fuse_morph"])
def test_engine_fit_at_box_81_matches_jax(extra):
    """The demo blend (3 bands, 40 x 44) with two components of box 81,
    past the 73 pixels of K5's and K6's register kernels: 5 iterations
    of the JAX kernels (interpret mode) against the port."""
    config, data, state = graft._demo_setup(box=81, H=40, W=44)
    config = dataclasses.replace(config, mono_n_iters=(16,), use_pallas=True,
                                 pallas_interpret=True, **extra)
    with pytest.raises(ValueError):
        kn.mono_geometry(81, 81)
    out_j, loss_j = jeng.fit_scan(state, data, config, 5)
    cfg, d, s = convert.from_jax(dataclasses.asdict(config),
                                 jax.device_get(data), jax.device_get(state),
                                 device="cpu")
    assert teng.packed_morphs_ok(cfg) == jeng.packed_morphs_ok(config)
    out_t, loss_t = teng.fit_scan(s, d, cfg, 5)
    assert_allclose(to_numpy(loss_t), np.asarray(loss_j), rtol=1e-5)
    for field in ("seds", "morphs"):
        for a, b in zip(getattr(out_t, field), getattr(out_j, field)):
            assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert_array_equal(to_numpy(out_t.it), np.asarray(out_j.it))


# ---------------------------------------------------------------------------
# MultiResFitter on a 6 + 4-channel pair
# ---------------------------------------------------------------------------
SMALL = dict(shape_hr=(32, 32), shape_lr=(12, 12))


def _jax_pair(th, tl, dh, dl):
    """The JAX package's observations of the port's pair: the same images,
    WCSs and PSFs (the JAX test's ``make_pair`` has one band each)."""
    crval = (150.0, 2.0)
    out = []
    for obs, data, scale, shape, sigma in (
            (th, dh, 0.1, SMALL["shape_hr"], SIGMA_PSF_HR),
            (tl, dl, 0.3, SMALL["shape_lr"], SIGMA_PSF_LR)):
        psf = gaussian_image(jwcs(scale, (21, 21), crval=crval), (21, 21),
                             [(1.0, 0, 0, sigma)], scale)[None]
        out.append(st.Observation(
            data, wcs=jwcs(scale, shape, crval=crval),
            psf=st.ImagePSF(np.repeat(psf, len(data), axis=0)),
            channels=list(obs.channels)))
    return tuple(out)


def test_multires_fit_at_six_plus_four_channels_matches_jax():
    """Three flux-scaled blends of the pair with 6 HR and 4 LR bands (10
    model channels), box 15, 15 iterations: both packages' init agree
    (rtol 1e-6), then the fits from the port's init."""
    th, tl, dh, dl = make_pair(device="cpu", bands=(6, 4), **SMALL)
    jh, jlo = _jax_pair(th, tl, dh, dl)
    tf = tm.Frame.from_observations([tl, th], obs_id=1)
    st.Frame.from_observations([jlo, jh], obs_id=1)
    assert len(tf.channels) == 10
    scales = np.asarray([1.0, 0.7, 1.5], np.float32)[:, None, None, None]
    datas = (dh[None] * scales, dl[None] * scales)
    weights = tuple(np.full_like(x, 400.0) for x in datas)
    centers = blob_centers(tf, 3)
    ji = jmr.multires_init((jh, jlo), datas, centers, box_size=15,
                           n_slots=3)
    ti = tmr.multires_init((th, tl), datas, centers, box_size=15, n_slots=3)
    for a, b in zip(ji, ti):
        assert_allclose(b, np.asarray(a), rtol=1e-6, atol=0)
    assert ti[0].shape[-1] == 10
    jout = jmr.MultiResFitter((jh, jlo), box_size=15).fit(
        datas, weights, *ti, n_iter=15)
    tout = tmr.MultiResFitter((th, tl), box_size=15).fit(
        datas, weights, *ti, n_iter=15)
    seds, morphs, loss, iters, losses = (np.asarray(a) for a in jout)
    got = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
           else np.asarray(x) for x in tout]
    assert_allclose(got[4], losses, rtol=1e-4)
    assert_allclose(got[2], loss, rtol=1e-4)
    for g, r in ((got[0], seds), (got[1], morphs)):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()
    assert_array_equal(got[3], iters)
