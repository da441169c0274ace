"""The port's wavelet initialization recipe and monotonic-mask seeds
against the JAX package's on the CPU, on generated blends (seeds 0, 1, 2
and 4) at box 31.

- the monotonic mask: the batched closure (``monotonic_mask_device``)
  against JAX's closure and JAX's host flood fill
  (``prox_monotonic_mask(max_iter=0)``), bit for bit in ``valid`` and
  ``model``; the host fill's ``(valid, model, bounds)`` and
  ``bounds_to_bbox`` bit for bit;
- ``get_detect_wavelets`` and the host ``get_multiresolution_support``:
  masks exactly, coefficients to 1e-6 of their largest value;
- the host recipes (``init_all_sources_wavelets``,
  ``init_all_sources_main(use_mask=True)``): component counts, boxes and
  origins exactly, seds and morphs to rtol 1e-4 / atol 1e-4;
- the device stream (``stream_setup(recipe="wavelets")`` and
  ``stream_setup(use_mask=True)``): the discrete init decisions exactly,
  seds and morphs to rtol 1e-4 / atol 1e-4 (FFT and sum order), and 12
  fit iterations: iterations exactly, logL to rtol 1e-4.

The stream's multiresolution support sums in float64 and JAX's in
float32; a coefficient exactly at ``K sigma`` could part the two masks.
No such tie shows on these seeds at box 31, so none was dropped.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu import detect as jdetect
from scarlet_tpu import lite as jlite
from scarlet_tpu.ops import prox as jprox
from scarlet_tpu.ops import wavelet as jwav
from scarlet_tpu.parallel import batch as jbatch
from scarlet_tpu.parallel import stream as jstream
from scarlet_tpu_torch import detect as tdetect
from scarlet_tpu_torch import lite as tlite
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.ops import prox as tprox
from scarlet_tpu_torch.ops import wavelet as twav
from scarlet_tpu_torch.parallel import batch as tbatch
from scarlet_tpu_torch.parallel import stream as tstream
from scarlet_tpu_torch.testing import generate_blend
from test_torch_stream import DISCRETE, MODEL_PSF, _heterogeneous

SEEDS = (0, 1, 2, 4)
BOX = 31


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blends():
    return {s: generate_blend(np.random.default_rng(s)) for s in SEEDS}


@pytest.fixture(scope="module")
def het():
    return _heterogeneous(SEEDS)


def _centers(d):
    return [(int(np.round(r["y"])), int(np.round(r["x"])))
            for r in d["catalog"]]


def _chi2(d):
    rms = np.mean(np.sqrt(d["variance"]), axis=(1, 2))
    return np.sum(d["images"] / (rms ** 2)[:, None, None], axis=0)


def _snake():
    """test_constraint.py's 9 x 9 snake: a monotone ridge that winds away
    from the center and back past it."""
    X = np.zeros((9, 9), np.float32)
    path = [(4, 4), (4, 5), (4, 6), (3, 6), (2, 6), (2, 5), (2, 4),
            (2, 3), (2, 2), (3, 2), (4, 2), (5, 2), (6, 2)]
    for i, (y, x) in enumerate(path):
        X[y, x] = 10.0 - i * 0.5
    return X


def _tie():
    """Two equal maxima in the center's 3 x 3 window: the first in row
    order is the peak, and only it reaches the ridge below it."""
    X = np.full((11, 13), 0.5, np.float32)
    X[4, 6] = X[6, 5] = 9.0
    X[3, 6] = 8.0
    X[7, 5] = 0.0
    return X


def _mask_cases(blends, case):
    if case == "chi2":
        return [(_chi2(d), c) for d in blends.values() for c in _centers(d)]
    if case == "snake":
        return [(_snake(), (4, 4))]
    if case == "tie":
        return [(_tie(), (5, 6))]
    d = _chi2(blends[0])
    H, W = d.shape
    return [(d, (0, 0)), (d, (H - 1, W - 1)), (d, (0, W - 1)),
            (d, (H - 1, 3)), (d, (H // 2, 0))]


@pytest.mark.parametrize("case", ["chi2", "snake", "tie", "edge"])
def test_mask_device_matches_jax_and_host(blends, case):
    """The batched closure equals JAX's closure and JAX's host flood fill
    bit for bit, every case in one call."""
    cases = _mask_cases(blends, case)
    shape = cases[0][0].shape
    assert all(x.shape == shape for x, _ in cases)
    X = np.stack([x for x, _ in cases]).astype(np.float32)
    centers = np.array([c for _, c in cases])
    tprox.reset_mask_counts()
    valid, model = tprox.monotonic_mask_device(torch.from_numpy(X),
                                               torch.from_numpy(centers))
    counts = tprox.mask_counts()
    assert counts["host_syncs"] >= 1
    assert counts["passes"] == tprox.MASK_PASSES * counts["host_syncs"]
    for k, (x, c) in enumerate(cases):
        vj, mj = jprox.monotonic_mask_device(jnp.asarray(X[k]), c)
        vh, mh, _ = jprox.prox_monotonic_mask(X[k], 0, c, max_iter=0)
        assert_array_equal(valid[k].numpy(), np.asarray(vj))
        assert_array_equal(valid[k].numpy(), vh)
        assert_array_equal(model[k].numpy().view(np.int32),
                           np.asarray(mj).view(np.int32))
        assert_array_equal(model[k].numpy(), mh)
    if case == "snake":
        assert valid[0, 6, 2] and valid.sum() == 13
    if case == "tie":
        assert valid[0, 3, 6] and not valid[0, 7, 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_host_mask_and_bounds_match_jax(blends, seed):
    """The host fill's (valid, model, bounds) and their box bit for bit,
    at every catalog center of the chi^2 image and of the float64
    detectlets (the fill runs on their float32 values, as JAX's native
    fill does)."""
    d = blends[seed]
    images = [_chi2(d), jdetect.get_detect_wavelets(
        d["images"], d["variance"], scales=5)[:-1].clip(0).sum(0)]
    for x in images:
        for c in _centers(d):
            got = tprox.prox_monotonic_mask(x, 0, c, max_iter=0)
            ref = jprox.prox_monotonic_mask(x, 0, c, max_iter=0)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                assert_array_equal(a, b)
            assert tdetect.bounds_to_bbox(got[2]).bounds == \
                jdetect.bounds_to_bbox(ref[2]).bounds


def test_mask_interpolation_not_ported():
    """The orphan interpolation (``max_iter > 0``), which raised before it
    was ported with the object tree, gives the JAX package's mask, model
    and bounds bit for bit on the snake."""
    got = tprox.prox_monotonic_mask(_snake(), 0, (4, 4), max_iter=1)
    ref = jprox.prox_monotonic_mask(_snake(), 0, (4, 4), max_iter=1)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_detect_wavelets_match_jax(blends, seed):
    d = blends[seed]
    got = tdetect.get_detect_wavelets(d["images"], d["variance"], scales=5)
    ref = jdetect.get_detect_wavelets(d["images"], d["variance"], scales=5)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert_array_equal(got != 0, ref != 0)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    # the support alone, on the JAX coefficients
    detect = np.sum(d["images"], axis=0)
    coeffs = np.asarray(jwav.starlet_transform(detect, scales=5))
    sigma = np.median(np.sqrt(d["variance"]))
    assert_array_equal(
        twav.get_multiresolution_support(detect, coeffs, sigma),
        jwav.get_multiresolution_support(detect, coeffs, sigma))


def _observation(lite, d):
    weights = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    # both packages get the same noise level (JAX's float32 mean drifts)
    nrms = np.sqrt(d["variance"].astype(np.float64)).mean(
        axis=(1, 2)).astype(np.float32)
    return lite.LiteObservation(
        d["images"], d["variance"], weights, d["psfs"],
        model_psf=MODEL_PSF, noise_rms=nrms,
        **({"device": "cpu"} if lite is tlite else {}))


def _assert_sources_match(got, ref):
    assert [len(s.components) for s in got] == \
        [len(s.components) for s in ref]
    for a, b in zip(got, ref):
        for ca, cb in zip(a.components, b.components):
            assert ca.bbox == cb.bbox
            assert tuple(ca.bbox.origin) == tuple(cb.bbox.origin)
            assert_allclose(to_numpy(ca.sed), np.asarray(cb.sed),
                            rtol=1e-4, atol=1e-4)
            assert_allclose(to_numpy(ca.morph), np.asarray(cb.morph),
                            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [{}, {"min_snr": 1e9}],
                         ids=["default", "psf"])
def test_host_wavelet_recipe_matches_jax(blends, seed, kw):
    d = blends[seed]
    got = tlite.init_all_sources_wavelets(_observation(tlite, d),
                                          _centers(d), **kw)
    ref = jlite.init_all_sources_wavelets(_observation(jlite, d),
                                          _centers(d), **kw)
    _assert_sources_match(got, ref)
    if kw:
        assert all(len(s.components) == 1 for s in got)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_main_use_mask_matches_jax(blends, seed):
    d = blends[seed]
    got = tlite.init_all_sources_main(_observation(tlite, d), _centers(d),
                                      use_mask=True)
    ref = jlite.init_all_sources_main(_observation(jlite, d), _centers(d),
                                      use_mask=True)
    _assert_sources_match(got, ref)


def test_init_monotonic_morph_use_mask(blends):
    """``use_mask=True`` (the default) runs, with the grown, centered box
    of the JAX package."""
    d = blends[0]
    obs = _observation(tlite, d)
    c = _centers(d)[0]
    box, morph = tlite.init_monotonic_morph(_chi2(d), c, obs.bbox[1:],
                                            grow=3)
    jbox, jmorph = jlite.init_monotonic_morph(_chi2(d), c, obs.bbox[1:],
                                              grow=3)
    assert box == jbox and tuple(box.origin) == tuple(jbox.origin)
    assert_array_equal(morph, jmorph)


def test_host_wavelet_blend_fits_like_jax(blends):
    """init_all_sources_wavelets -> parameterize_sources -> LiteBlend.fit
    in both packages: iterations exactly, logL to rtol 1e-4."""
    out = []
    for lite in (tlite, jlite):
        d = blends[1]
        obs = _observation(lite, d)
        src = lite.parameterize_sources(
            lite.init_all_sources_wavelets(obs, _centers(d)), obs,
            lite.init_adaprox_component)
        blend = lite.LiteBlend(src, obs)
        kw = {"device": "cpu"} if lite is tlite else {}
        it, logL = blend.fit(12, e_rel=1e-4, **kw)
        out.append((it, float(logL)))
    assert out[0][0] == out[1][0]
    assert_allclose(out[0][1], out[1][1], rtol=1e-4)


def _setups(inp, **kw):
    args = (inp["images"], inp["variance"], inp["psfs"], inp["centers"],
            MODEL_PSF)
    kw = dict(center_active=inp["active"], box_size=BOX, n_slots=16, **kw)
    return (jstream.stream_setup(*args, platform="cpu", **kw),
            tstream.stream_setup(*args, device="cpu", **kw))


@pytest.mark.parametrize("kw", [
    dict(recipe="wavelets"), dict(use_mask=True),
    dict(recipe="wavelets", min_snr=1e9),
    dict(recipe="wavelets", grow=3, wavelet_scales=4, bulge_scales=1,
         use_psf=False)], ids=["wavelets", "mask", "psf", "knobs"])
def test_stream_setup_matches_jax(het, kw):
    """The discrete init decisions exactly, seeds to rtol/atol 1e-4; then
    12 fit iterations (all but the PSF case): iterations exactly, logL to
    rtol 1e-4.  The knobs case sets every wavelet-recipe knob away from its
    default."""
    (cj, dj, sj, aj), (ct, dt, st, at) = _setups(het, **kw)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    for k in DISCRETE:
        assert_array_equal(at[k].numpy(), np.asarray(aj[k]))
    for f in ("origins", "comp_active"):
        assert_array_equal(getattr(st, f)[0].numpy(),
                           np.asarray(getattr(sj, f)[0]))
    assert_array_equal(dt.box_masks[0].numpy(), np.asarray(dj.box_masks[0]))
    assert_allclose(st.seds[0].numpy(), np.asarray(sj.seds[0]), rtol=1e-4,
                    atol=1e-4)
    assert_allclose(st.morphs[0].numpy(), np.asarray(sj.morphs[0]),
                    rtol=1e-4, atol=1e-4)
    if kw.get("min_snr"):
        assert at["psf_fallback"][het["active"]].all()
        assert not at["split"].any()
        return
    assert at["split"].any()
    out_j, _ = jbatch.fit_batch_device_converged(sj, dj, cj, 12,
                                                 check_every=6)
    out_t, _ = tbatch.fit_batch_device_converged(st, dt, ct, 12,
                                                 check_every=6)
    assert_array_equal(out_t.it.numpy(), np.asarray(out_j.it))
    assert_allclose(out_t.last_loss.numpy(), np.asarray(out_j.last_loss),
                    rtol=1e-4)


def test_stream_mask_closure_batched_once(het, monkeypatch):
    """The wavelet recipe masks its three dictionaries of a chunk in one
    closure call."""
    calls = []
    orig = tprox.monotonic_mask_device

    def spy(x, centers, *a, **k):
        calls.append(tuple(x.shape))
        return orig(x, centers, *a, **k)

    monkeypatch.setattr(tprox, "monotonic_mask_device", spy)
    tprox.reset_mask_counts()
    tstream.stream_setup(
        het["images"], het["variance"], het["psfs"], het["centers"],
        MODEL_PSF, center_active=het["active"], box_size=BOX, n_slots=16,
        recipe="wavelets", device="cpu")
    B, K = het["active"].shape
    assert calls == [(B, K, 3, BOX, BOX)]
    counts = tprox.mask_counts()
    assert counts["host_syncs"] >= 1
    assert counts["passes"] == tprox.MASK_PASSES * counts["host_syncs"]


def test_deblend_stream_wavelets_plumbing(het):
    """Chunks of 2, compaction at 10, an overflow retry (n_slots 8), with
    the wavelet recipe; then device detection feeding it."""
    args = (het["images"], het["variance"], het["psfs"])
    kw = dict(box_size=BOX, max_iter=20, check_every=10, chunk=2,
              compact=10, retry_overflow=True, recipe="wavelets",
              device="cpu")
    recs, _, _, aux = tstream.deblend_device_stream(
        *args, het["centers"], MODEL_PSF, center_active=het["active"],
        n_slots=8, **kw)
    assert len(recs) == len(SEEDS)
    assert any(r.get("overflow_retried") for r in recs)
    assert all(np.isfinite(r["logL"]) and np.isfinite(r["flux"]).all()
               for r in recs)
    recs, _, _, aux = tstream.deblend_device_stream(
        *args, None, MODEL_PSF, n_slots=12, **kw)
    assert all(np.isfinite(r["logL"]) for r in recs)
    assert all(r["logL"] > r["init logL"] for r in recs)
