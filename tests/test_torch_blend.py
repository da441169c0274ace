"""The port's ``Blend.fit`` against the JAX package's on the CPU, from the
same start: the JAX package initializes the sources and
``convert.sources_from_jax`` carries them across.

Inputs: ``generate_blend`` blends of (3, 40, 40) with 3 sources (seeds 0
and 2, not borderline), float64 model frames and float64 PSF images (so
that both packages compute in float64; see tests/test_torch_sources.py),
a Gaussian model PSF of sigma 0.8; for the box resize a single extended
galaxy (a Gaussian of sigma 5 px) seeded as a ``CompactExtendedSource``,
whose box grows at iteration 20 and shrinks back at 30.

Tolerances: fits from a joint least-squares start (``init_all_sources``)
to 1e-5 relative in the loss and 5e-5 of each parameter's largest value
after 20 iterations: the start is the spectra's least-squares optimum,
where their gradient is roundoff (~1e-12) that the first adaprox steps
divide by their own square root, so both packages' different FFT and
sum orders show at ~1e-7 and grow over the fit.  Fits from a seed with a
real gradient (the resize case, the ``psf_shift`` fit) to 1e-10
relative.  Convergence and resize iterations and boxes equal.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import scarlet_tpu as st
from scarlet_tpu.testing.blendsets import generate_blend
from scarlet_tpu_torch import convert, initialization
from scarlet_tpu_torch import models as tm

SHAPE = (3, 40, 40)
N_ITER = 20


def _observations(images, weights, psfs, ch, dtype=np.float64,
                  device="cpu"):
    jframe = st.Frame(images.shape, channels=ch,
                      psf=st.GaussianPSF(sigma=0.8, boxsize=15), dtype=dtype)
    jobs = st.Observation(images, psf=st.ImagePSF(psfs), weights=weights,
                          channels=ch).match(jframe)
    tframe = tm.Frame(images.shape, channels=ch,
                      psf=tm.GaussianPSF(sigma=0.8, boxsize=15), dtype=dtype)
    tobs = tm.Observation(images, ch, psf=tm.ImagePSF(psfs), weights=weights,
                          device=device).match(tframe)
    return jframe, jobs, tframe, tobs


def _blend(seed, dtype=np.float64):
    d = generate_blend(np.random.default_rng(seed), shape=SHAPE, n_sources=3)
    centers = [(float(r["y"]), float(r["x"])) for r in d["catalog"]]
    return (*_observations(d["images"], (1 / d["variance"]).astype(
        np.float32), d["psfs"].astype(np.float64), list(d["filters"]),
        dtype), centers)


def _start(seed):
    """Both packages' sources from the JAX package's init."""
    jframe, jobs, tframe, tobs, centers = _blend(seed)
    jsrc, _ = st.initialization.init_all_sources(
        jframe, centers, jobs, max_components=2, min_snr=30, silent=True)
    tsrc = convert.sources_from_jax(jsrc, tframe, device="cpu")
    return jframe, jobs, jsrc, tframe, tobs, tsrc


@pytest.fixture(scope="module")
def fits():
    """Per seed, both packages' 20-iteration fits from the same start."""
    out = {}
    for seed in (0, 2):
        jframe, jobs, jsrc, tframe, tobs, tsrc = _start(seed)
        jb = st.Blend(jsrc, jobs)
        jb.fit(N_ITER, e_rel=0)
        tb = tm.Blend(tsrc, tobs)
        tb.fit(N_ITER, e_rel=0)
        out[seed] = (jb, tb)
    return out


def _rel(a, b):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("seed", (0, 2))
def test_fit_losses_and_parameters(fits, seed):
    jb, tb = fits[seed]
    assert len(tb.loss) == len(jb.loss) == N_ITER
    assert_allclose(tb.loss, jb.loss, rtol=1e-5)
    assert_allclose(tb.log_likelihood, jb.log_likelihood, rtol=1e-5)
    for jp, tp in zip(jb.parameters, tb.parameters):
        assert jp.name == tp.name
        if jp.fixed:
            continue
        assert _rel(jp.value, tp.value) < 5e-5, jp.name
        # std = 1/sqrt(v): inf where v is 0 (pixels the fit never moved)
        jstd, tstd = np.asarray(jp.std), np.asarray(tp.std)
        finite = np.isfinite(jstd)
        np.testing.assert_array_equal(np.isfinite(tstd), finite)
        assert _rel(jstd[finite], tstd[finite]) < 5e-4, jp.name
    assert _rel(jb.get_model(), tb.get_model()) < 5e-5


def test_fit_converges_at_the_same_iteration():
    for seed in (0, 2):
        jframe, jobs, jsrc, tframe, tobs, tsrc = _start(seed)
        jit, jlogL = st.Blend(jsrc, jobs).fit(100, e_rel=1e-3)
        tb = tm.Blend(tsrc, tobs)
        tit, tlogL = tb.fit(100, e_rel=1e-3)
        assert tit == jit < 100
        assert_allclose(tlogL, jlogL, rtol=1e-5)


def test_segments_equal_single_steps():
    """The device-side convergence mask gives the per-iteration sequence
    (segment=1) at segment=10."""
    runs = []
    for segment in (1, 10):
        *_, tframe, tobs, tsrc = _start(0)
        tb = tm.Blend(tsrc, tobs)
        tb.fit(15, e_rel=1e-3, segment=segment)
        runs.append(np.array(tb.loss))
    np.testing.assert_array_equal(runs[0], runs[1])


def _galaxy():
    """One extended Gaussian galaxy (sigma 5 px) in 3 bands, 48 x 48."""
    d = generate_blend(np.random.default_rng(0), shape=SHAPE, n_sources=3)
    yy, xx = np.mgrid[:48, :48]
    gal = np.exp(-((yy - 24) ** 2 + (xx - 23.6) ** 2) / (2 * 5.0 ** 2))
    noise = np.random.default_rng(5).normal(0, 0.1, (3, 48, 48))
    images = (np.array([30.0, 20.0, 10.0])[:, None, None] * gal
              + noise).astype(np.float32)
    return _observations(images, np.full_like(images, 100.0),
                         d["psfs"].astype(np.float64), list(d["filters"]))


def test_box_resize_restarts_at_the_same_iteration():
    """The edge pull grows the box at iteration 20 and the empty border
    shrinks it at 30; each restart keeps warm moments at the new shape."""
    jframe, jobs, tframe, tobs = _galaxy()
    jsrc = [st.CompactExtendedSource(jframe, (24.0, 23.6), jobs)]
    tsrc = convert.sources_from_jax(jsrc, tframe, device="cpu")
    jb, tb = st.Blend(jsrc, jobs), tm.Blend(tsrc, tobs)
    boxes = []
    for n in (10, 20, 30):
        jb.fit(n, e_rel=0)
        tb.fit(n, e_rel=0)
        boxes.append((tuple(jsrc[0].bbox.shape), tuple(jsrc[0].bbox.origin),
                      tuple(tsrc[0].bbox.shape), tuple(tsrc[0].bbox.origin)))
    assert [b[:2] for b in boxes] == [b[2:] for b in boxes]
    assert [b[0][-1] for b in boxes] == [21, 31, 21]
    assert_allclose(tb.loss, jb.loss, rtol=1e-10)
    image = tsrc[0].morphology.parameters[0]
    assert image.shape == (21, 21) and image.m.shape == (21, 21)
    assert _rel(jsrc[0].get_model(), tsrc[0].get_model()) < 1e-10


def test_psf_shift_is_fitted():
    """A ``ConvolutionRenderer`` with a ``psf_shift`` parameter: the shift
    is free and moves as in the JAX package."""
    jframe, jobs, tframe, tobs = _galaxy()
    jobs.match(jframe, renderer=st.ConvolutionRenderer(
        jobs, jframe, psf_shift=(0.1, -0.15)))
    tobs.match(tframe, renderer=tm.ConvolutionRenderer(
        tobs, tframe, psf_shift=(0.1, -0.15)))
    jsrc = [st.CompactExtendedSource(jframe, (24.0, 23.6), jobs)]
    tsrc = convert.sources_from_jax(jsrc, tframe, device="cpu")
    jb, tb = st.Blend(jsrc, jobs), tm.Blend(tsrc, tobs)
    jb.fit(8, e_rel=0)
    tb.fit(8, e_rel=0)
    assert_allclose(tb.loss, jb.loss, rtol=1e-10)
    shift = tobs.parameters[0]
    assert shift.name == "psf_shift" and not shift.fixed
    assert np.abs(shift.host() - np.array([0.1, -0.15])).max() > 1e-3
    assert_allclose(shift.host(), np.asarray(jobs.parameters[0].value),
                    rtol=1e-9)


def test_noise_redraws_follow_the_seeded_stream():
    """``noise_factor`` re-draws from numpy's global stream by default (as
    the JAX package draws) or from an explicit generator."""
    jframe, jobs, tframe, tobs = _galaxy()
    jsrc = [st.CompactExtendedSource(jframe, (24.0, 23.6), jobs)]
    losses = []
    for rng in (None, None, np.random.default_rng(1),
                np.random.default_rng(1)):
        np.random.seed(11)
        tb = tm.Blend(convert.sources_from_jax(jsrc, tframe, device="cpu"),
                      tobs)
        tb.fit(3, e_rel=0, noise_factor=1, rng=rng)
        losses.append(np.array(tb.loss))
    np.random.seed(11)
    jb = st.Blend(jsrc, jobs)
    jb.fit(3, e_rel=0, noise_factor=1)
    np.testing.assert_array_equal(losses[0], losses[1])
    np.testing.assert_array_equal(losses[2], losses[3])
    assert_allclose(losses[0], jb.loss, rtol=1e-10)
    assert np.abs(losses[0] - losses[2]).max() > 0


def test_quickstart_in_float32():
    """The port's default precision end to end on the CPU: float32 frame,
    init, fit in float32 (the observations' precision), improving the
    logL to a chi2/dof near 1."""
    jframe, jobs, tframe, tobs, centers = _blend(1, dtype=np.float32)
    sources, skipped = initialization.init_all_sources(
        tframe, centers, tobs, max_components=2, min_snr=30, silent=True)
    blend = tm.Blend(sources, tobs)
    it, logL = blend.fit(30, e_rel=1e-4)
    assert np.isfinite(logL) and logL > blend.log_likelihood[0]
    assert all(p.value.dtype == torch.float32 for p in blend.parameters)
    model = tobs.render(blend.get_model()).numpy()
    chi2 = float(np.mean(tobs.weights.numpy()
                         * (tobs.data.numpy() - model) ** 2))
    assert chi2 < 2.0
