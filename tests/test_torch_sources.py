"""The port's source initialization, sources, measurements and their
pickling against the JAX package on the CPU.

Inputs: ``generate_blend`` blends of (3, 40, 40) with 3 sources (seeds 0,
1, 2, 4, whose init decisions are not borderline, ROADMAP Queue 3 traps),
plus one center off the frame; a Gaussian model PSF of sigma 0.8.  Both
packages get the same numpy arrays.  Unless a test says otherwise the
model frames are float64 and the PSF images float64 (so that the
difference kernel is computed in float64 on both sides: in float32 the
JAX package rounds it to float32, the port keeps it in float64, and the
renders differ by ~1e-6), so the JAX package with 64-bit mode on and the
port's CPU path both compute in float64.

Tolerances: init decisions (classes, component counts, boxes, skipped
centers) equal; morphologies to 1e-12 and spectra to 1e-9 of their
largest value (the spectra come from a least-squares solve of the
renders, whose FFT and sum orders differ); the one-by-one sources'
models to 1e-12; measurements to 1e-9 relative; pickled sources reload
to the same model bit for bit.
"""
import pickle

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import scarlet_tpu as st
from scarlet_tpu.testing.blendsets import generate_blend
from scarlet_tpu_torch import convert, initialization, measure
from scarlet_tpu_torch import models as tm

SEEDS = (0, 1, 2, 4)
SHAPE = (3, 40, 40)
OFF_FRAME = (100.0, 100.0)


def _pair(seed, dtype=np.float64):
    """(JAX frame, JAX observation, port frame, port observation,
    centers) of one generated blend."""
    d = generate_blend(np.random.default_rng(seed), shape=SHAPE, n_sources=3)
    images = d["images"]
    weights = (1 / d["variance"]).astype(np.float32)
    psfs = d["psfs"].astype(np.float64)
    ch = list(d["filters"])
    centers = [(float(r["y"]), float(r["x"])) for r in d["catalog"]]
    jframe = st.Frame(images.shape, channels=ch,
                      psf=st.GaussianPSF(sigma=0.8, boxsize=15), dtype=dtype)
    jobs = st.Observation(images, psf=st.ImagePSF(psfs), weights=weights,
                          channels=ch).match(jframe)
    tframe = tm.Frame(images.shape, channels=ch,
                      psf=tm.GaussianPSF(sigma=0.8, boxsize=15), dtype=dtype)
    tobs = tm.Observation(images, ch, psf=tm.ImagePSF(psfs), weights=weights,
                          device="cpu").match(tframe)
    return jframe, jobs, tframe, tobs, centers


def _init(pair):
    jframe, jobs, tframe, tobs, centers = pair
    kw = dict(max_components=2, min_snr=30, silent=True)
    centers = centers + [OFF_FRAME]
    return (st.initialization.init_all_sources(jframe, centers, jobs, **kw),
            initialization.init_all_sources(tframe, centers, tobs, **kw))


@pytest.fixture(scope="module")
def inits():
    """Per seed: the observations and both packages' init_all_sources."""
    out = {}
    for seed in SEEDS:
        pair = _pair(seed)
        out[seed] = (pair, *_init(pair))
    return out


def _rel(a, b):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _decisions(sources, skipped):
    return ([type(s).__name__ for s in sources],
            [len(s.children) if isinstance(s, (st.CombinedComponent,
                                               tm.CombinedComponent)) else 1
             for s in sources],
            [(tuple(s.bbox.shape), tuple(s.bbox.origin)) for s in sources],
            list(skipped))


@pytest.mark.parametrize("seed", SEEDS)
def test_init_all_sources_decisions_equal(inits, seed):
    _, (jsrc, jsk), (tsrc, tsk) = inits[seed]
    assert _decisions(tsrc, tsk) == _decisions(jsrc, jsk)
    assert tsk == [3]          # the center off the frame


@pytest.mark.parametrize("seed", SEEDS)
def test_init_all_sources_parameters(inits, seed):
    _, (jsrc, _), (tsrc, _) = inits[seed]
    for js, ts in zip(jsrc, tsrc):
        for jp, tp in zip(js.parameters, ts.parameters):
            assert jp.name == tp.name and jp.shape == tp.shape
            assert tp.value.dtype == torch.float64
            tol = 1e-9 if jp.name == "spectrum" else 1e-12
            assert _rel(jp.value, tp.value) <= tol, (jp.name, seed)
            assert jp.fixed == tp.fixed


def test_init_decisions_equal_in_float32():
    """The port's default precision (float32 frame) takes the same
    decisions as the JAX package in float32 frames."""
    pair = _pair(1, dtype=np.float32)
    (jsrc, jsk), (tsrc, tsk) = _init(pair)
    assert _decisions(tsrc, tsk) == _decisions(jsrc, jsk)
    for js, ts in zip(jsrc, tsrc):
        assert _rel(js.get_model(frame=pair[0]),
                    ts.get_model(frame=pair[2])) < 1e-5


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_init_models_and_measures(inits, seed):
    (jframe, jobs, tframe, tobs, _), (jsrc, _), (tsrc, _) = inits[seed]
    for js, ts in zip(jsrc, tsrc):
        assert _rel(js.get_model(frame=jframe),
                    ts.get_model(frame=tframe)) < 1e-9
        assert_array_equal(st.measure.max_pixel(js), measure.max_pixel(ts))
        assert _rel(st.measure.flux(js), measure.flux(ts)) < 1e-9
        assert _rel(st.measure.centroid(js), measure.centroid(ts)) < 1e-9
        assert _rel(st.measure.snr(js, jobs), measure.snr(ts, tobs)) < 1e-9
        jm, tmom = st.measure.moments(js), measure.moments(ts)
        assert jm.keys() == tmom.keys()
        # first moments about the box center cancel to roundoff: hold each
        # to the largest moment
        scale = max(np.abs(np.asarray(v)).max() for v in jm.values())
        for k in jm:
            assert_allclose(tmom[k], jm[k], rtol=0, atol=1e-9 * scale)
    # a raw array measures alike
    cube = np.asarray(jsrc[0].get_model())
    assert _rel(st.measure.flux(cube), measure.flux(torch.from_numpy(cube))) \
        < 1e-15


def test_build_initialization_image_and_psf_spectrum(inits):
    (_, jobs, _, tobs, centers), _, _ = inits[0]
    spectra = st.initialization.get_pixel_spectrum(centers[0], jobs,
                                                   concat=False)
    tspectra = initialization.get_pixel_spectrum(centers[0], tobs,
                                                 concat=False)
    assert_allclose(tspectra[0], spectra[0], rtol=1e-15)
    for a, b in zip(st.initialization.build_initialization_image(
            jobs, spectra=spectra[0]),
            initialization.build_initialization_image(
                tobs, spectra=tspectra[0])):
        assert _rel(a, b) < 1e-12
    js, jsnr = st.initialization.get_psf_spectrum(centers[1], jobs,
                                                  compute_snr=True)
    ts, tsnr = initialization.get_psf_spectrum(centers[1], tobs,
                                               compute_snr=True)
    assert _rel(js, ts) < 1e-12 and _rel(jsnr, tsnr) < 1e-12
    assert_allclose(
        initialization.get_pixel_spectrum(centers[0], tobs,
                                          correct_psf=True),
        st.initialization.get_pixel_spectrum(centers[0], jobs,
                                             correct_psf=True), rtol=1e-12)


@pytest.mark.parametrize("kind", [
    "gaussian", "gaussian_elliptic", "spergel", "point", "compact", "single",
    "multi"])
def test_sources_one_by_one(inits, kind):
    (jframe, jobs, tframe, tobs, centers), _, _ = inits[2]
    c = centers[1]

    def make(mod, frame, obs):
        if kind == "gaussian":
            return mod.GaussianSource(frame, c, 1.6, None, obs)
        if kind == "gaussian_elliptic":
            return mod.GaussianSource(frame, c, 1.6, (0.2, -0.1), obs)
        if kind == "spergel":
            return mod.SpergelSource(frame, c, 0.5, 2.0, (0.1, 0.05), obs)
        if kind == "point":
            return mod.PointSource(frame, c, obs)
        if kind == "compact":
            return mod.CompactExtendedSource(frame, c, obs)
        if kind == "single":
            return mod.SingleExtendedSource(frame, c, obs)
        return mod.MultiExtendedSource(frame, c, obs, K=2)

    js = make(st, jframe, jobs)
    ts = make(tm, tframe, tobs)
    assert type(ts).__name__ == type(js).__name__
    assert tuple(ts.bbox.shape) == tuple(js.bbox.shape)
    assert tuple(ts.bbox.origin) == tuple(js.bbox.origin)
    for jp, tp in zip(js.parameters, ts.parameters):
        assert jp.name == tp.name and jp.fixed == tp.fixed
        assert _rel(jp.value, tp.value) < 1e-12, jp.name
    assert _rel(js.get_model(frame=jframe), ts.get_model(frame=tframe)) \
        < 1e-12
    assert_allclose(np.asarray(ts.center), np.asarray(js.center), rtol=1e-15)


def test_profile_morphology_update_and_integral(inits):
    (jframe, jobs, tframe, tobs, centers), _, _ = inits[0]
    js = st.GaussianSource(jframe, centers[0], 1.2, None, jobs)
    ts = tm.GaussianSource(tframe, centers[0], 1.2, None, tobs)
    for src in (js, ts):
        src.morphology.parameters[1].set(np.array([2.6]))
    for src, exc in ((js, st.UpdateException), (ts, tm.UpdateException)):
        with pytest.raises(exc):
            src.morphology.update()
    assert tuple(ts.morphology.bbox.shape) == tuple(js.morphology.bbox.shape)
    assert _rel(js.morphology.get_model(), ts.morphology.get_model()) < 1e-12
    assert _rel(js.morphology.integral, ts.morphology.integral) < 1e-15


def test_random_and_null_sources(inits):
    (jframe, _, tframe, _, _), _, _ = inits[0]
    np.random.seed(3)
    js = st.RandomSource(jframe)
    np.random.seed(3)
    ts = tm.RandomSource(tframe)
    assert _rel(js.get_model(), ts.get_model()) == 0
    assert float(tm.NullSource(tframe).get_model().abs().sum()) == 0.0


def test_pickled_sources_reload_to_the_same_model(inits):
    (_, _, tframe, _, _), _, (tsrc, _) = inits[1]
    for src in tsrc:
        back = pickle.loads(pickle.dumps(src))
        assert_array_equal(back.get_model(frame=tframe).numpy(),
                           src.get_model(frame=tframe).numpy())
        assert tuple(back.bbox.shape) == tuple(src.bbox.shape)


def test_sources_from_jax_carry_the_tree(inits):
    (jframe, _, tframe, _, _), (jsrc, _), _ = inits[4]
    tsrc = convert.sources_from_jax(jsrc, tframe, device="cpu")
    assert [type(s).__name__ for s in tsrc] == \
        [type(s).__name__ for s in jsrc]
    for js, ts in zip(jsrc, tsrc):
        assert_array_equal(js.get_model(frame=jframe),
                           ts.get_model(frame=tframe).numpy())
        for jp, tp in zip(js.parameters, ts.parameters):
            assert jp.name == tp.name and jp.fixed == tp.fixed
            assert callable(jp.step) == callable(tp.step)


def test_entry_points_need_a_device_without_a_card():
    """With numpy inputs and no device, the observation (whose device the
    object tree runs on) raises on a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.Observation(np.zeros((1, 5, 5), np.float32), ["g"])


@pytest.mark.parametrize("center", [(40, 50), (5, 85), (95, 3)])
def test_seed_projection_of_a_large_frame_matches_jax(center):
    """The extended-source seed on a frame larger than 73 pixels a side
    (the box K1 takes on the card beyond it is ``mono_kernel_wide``'s):
    the whole frame is projected, as in the JAX package, so the port's
    ``SingleExtendedSource.init_morph`` gives the JAX package's box and
    morphology (run op by op) to 1e-12 of its largest value."""
    import jax

    rng = np.random.default_rng(12)
    H, W = 100, 90
    yy, xx = np.mgrid[:H, :W]
    detect = np.exp(-((yy - center[0]) ** 2 + (xx - center[1]) ** 2)
                    / (2 * 20.0 ** 2)) + 0.05 * rng.normal(size=(H, W))
    detect[center] = 2.0
    sky = (float(center[0]), float(center[1]))
    jframe = st.Frame((1, H, W), channels=["g"],
                      psf=st.GaussianPSF(sigma=0.8, boxsize=15),
                      dtype=np.float64)
    tframe = tm.Frame((1, H, W), channels=["g"],
                      psf=tm.GaussianPSF(sigma=0.8, boxsize=15),
                      dtype=np.float64)
    with jax.disable_jit():
        jmorph, jbox = st.SingleExtendedSource.init_morph(
            jframe, sky, detect, 0.05)
    tmorph, tbox = tm.SingleExtendedSource.init_morph(
        tframe, sky, detect, 0.05, device="cpu")
    assert tuple(tbox.shape) == tuple(jbox.shape)
    assert tuple(tbox.origin) == tuple(jbox.origin)
    assert max(jbox.shape) > 73
    assert _rel(jmorph, tmorph) < 1e-12
