"""The port's starlet transforms, ``Starlet``, the multiresolution support,
the wavelet denoiser, ``StarletMorphology``, ``StarletSource`` and their
fits, ``interpolate_observation`` and the pixel-integration helpers,
against the JAX package on the CPU.

Inputs: numpy images from seeded generators (frames of at most 64 px);
``generate_blend`` blends of (3, 40, 40) with 3 sources (seed 0, as in
tests/test_torch_blend.py) with float64 model frames and PSF images, so
both packages compute in float64 (JAX with 64-bit mode on); the JAX
tests' synthetic multi-resolution pair at its small widths
(tests/test_torch_resolution.py), aligned and rotated.

Tolerances: the transforms and reconstructions bit for bit (the JAX
functions run op by op, not jitted, and the port adds in the same
order); ``Starlet.norm``, and so the thresholds, within 8 ulp, not 2: the
transform of its dirac is the same to the bit, but the sum over each
plane's pixels is one XLA reduction (sequential up to 1024 pixels,
blocked beyond, batched over the planes) whose order torch's sum does
not reproduce (0-10 ulp apart over boxes of 11-128 px; 7 at the
32 x 28 image here); the reconstruction's autograd gradient to 1e-6 of
``jax.vjp``'s; the "space" support's masks equal under the same
``np.random.seed``; the denoiser to 1e-5 relative; the sources'
coefficients to 1e-6 of their largest value, boxes equal; fits to rtol
1e-6 in the loss; ``interpolate_observation`` and the pixel integration
to 1e-5 of the largest value.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import scarlet_tpu as st
from scarlet_tpu.ops import interpolation as jinterp
from scarlet_tpu.ops import wavelet as jw
from scarlet_tpu_torch import convert
from scarlet_tpu_torch import models as tm
from scarlet_tpu_torch.bbox import Box
from scarlet_tpu_torch.models import constraint as tcon
from scarlet_tpu_torch.ops import interpolation as tinterp
from scarlet_tpu_torch.ops import wavelet as tw

from test_torch_resolution import ROT, _observations
from test_torch_sources import _pair

N_ITER = 10
NORM_ULPS = 8
IMG = (32, 28)      # the transforms' test image: 3 scales


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _image(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref) / np.spacing(np.abs(ref))


# ---------------------------------------------------------------------------
# transforms, reconstructions, the Starlet class
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("generation", [1, 2])
def test_transform_and_reconstruction_bit_for_bit(generation, dtype):
    x = _image(IMG, dtype)
    ref = np.asarray(jw.starlet_transform(jnp.asarray(x),
                                          generation=generation))
    got = tw.starlet_transform(_t(x), generation=generation).numpy()
    assert got.dtype == ref.dtype
    assert_array_equal(got, ref)
    for scales in (1, 3):
        assert_array_equal(
            tw.starlet_transform(_t(x), scales, generation).numpy(),
            np.asarray(jw.starlet_transform(jnp.asarray(x), scales,
                                            generation)))
    assert_array_equal(
        tw.starlet_reconstruction(_t(ref), generation).numpy(),
        np.asarray(jw.starlet_reconstruction(jnp.asarray(ref), generation)))
    # batched leading axes: each image its own transform
    xs = _image((2, 3, *IMG), dtype, seed=1)
    got = tw.starlet_transform(_t(xs), generation=generation).numpy()
    assert_array_equal(got[1, 2], np.asarray(jw.starlet_transform(
        jnp.asarray(xs[1, 2]), generation=generation)))


@pytest.mark.parametrize("generation", [1, 2])
def test_multiband_transform_and_reconstruction_bit_for_bit(generation):
    x = _image((3, *IMG), np.float32)
    ref = np.asarray(jw.multiband_starlet_transform(jnp.asarray(x),
                                                    generation=generation))
    got = tw.multiband_starlet_transform(_t(x), generation=generation)
    assert tuple(got.shape) == ref.shape == (4, 3, *IMG)
    assert_array_equal(got.numpy(), ref)
    assert_array_equal(
        tw.multiband_starlet_reconstruction(_t(ref), generation).numpy(),
        np.asarray(jw.multiband_starlet_reconstruction(
            jnp.asarray(ref), generation)))


def test_custom_convolution_is_used():
    def box3(c, j):
        k = 2 ** j
        return (tw.shift_axis(c, k, -1) + c + tw.shift_axis(c, -k, -1)) / 3

    def jbox3(c, j):
        k = 2 ** j
        return (jnp.roll(c, k, -1).at[..., :k].set(0) + c
                + jnp.roll(c, -k, -1).at[..., -k:].set(0)) / 3

    x = _image(IMG, np.float64)
    got = tw.starlet_transform(_t(x), convolve2D=box3).numpy()
    ref = np.asarray(jw.starlet_transform(jnp.asarray(x), convolve2D=jbox3))
    assert_array_equal(got, ref)
    assert_array_equal(
        tw.starlet_reconstruction(_t(ref), convolve2D=box3).numpy(),
        np.asarray(jw.starlet_reconstruction(jnp.asarray(ref),
                                             convolve2D=jbox3)))


@pytest.mark.parametrize("shape", [IMG, (41, 41)])
def test_starlet_class(shape):
    x = np.abs(_image(shape, np.float64))
    js, ts = jw.Starlet.from_image(x), tw.Starlet.from_image(x)
    assert ts.scales == js.scales and ts.generation == js.generation == 2
    assert_array_equal(ts.coefficients.numpy(), np.asarray(js.coefficients))
    assert ts.norm.dtype == torch.float64
    assert _ulps(ts.norm.numpy(), js.norm).max() <= NORM_ULPS
    # setters and from_coefficients
    y = np.abs(_image(shape, np.float64, seed=3))
    js.image, ts.image = jnp.asarray(y), _t(y)
    assert_array_equal(ts.coefficients.numpy(), np.asarray(js.coefficients))
    c = np.asarray(js.coefficients) * 0.5
    js.coefficients, ts.coefficients = jnp.asarray(c), _t(c)
    assert_array_equal(ts.image.numpy(), np.asarray(js.image))
    jc = jw.Starlet.from_coefficients(jnp.asarray(c), generation=1)
    tc = tw.Starlet.from_coefficients(c, generation=1)
    assert_array_equal(tc.image.numpy(), np.asarray(jc.image))
    assert _ulps(tc.norm.numpy(), jc.norm).max() <= NORM_ULPS


def test_reconstruction_gradient_matches_vjp():
    c = _image((4, *IMG), np.float64)
    w = _image(IMG, np.float64, seed=2)
    _, vjp = jax.vjp(jw.starlet_reconstruction, jnp.asarray(c))
    ref = np.asarray(jax.jit(vjp)(jnp.asarray(w))[0])
    ct = _t(c).requires_grad_(True)
    (g,) = torch.autograd.grad(tw.starlet_reconstruction(ct), ct, _t(w))
    err = np.abs(g.numpy() - ref).max()
    assert err <= 1e-6 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# multiresolution support, denoiser
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("image_type", ["ground", "space"])
def test_multiresolution_support_matches_jax(image_type):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:IMG[0], :IMG[1]]
    image = (40 * np.exp(-((yy - 14) ** 2 + (xx - 15) ** 2) / 18.0)
             + rng.standard_normal(IMG)).astype(np.float32)
    coeffs = tw.starlet_transform(_t(image), scales=3).numpy()
    masks = []
    for get in (jw.get_multiresolution_support,
                tw.get_multiresolution_support):
        np.random.seed(11)
        masks.append(get(image, coeffs, 1.0, image_type=image_type))
    assert masks[1].dtype == masks[0].dtype
    assert_array_equal(masks[1], masks[0])
    assert 0 < masks[0].sum() < masks[0].size


@pytest.mark.parametrize("positive", [True, False])
def test_wavelet_denoising_matches_jax(positive):
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[:IMG[0], :IMG[1]]
    image = (10 * np.exp(-((yy - 14) ** 2 + (xx - 15) ** 2) / 30.0)
             + 0.5 * rng.standard_normal(IMG)).astype(np.float32)
    ref = jw.apply_wavelet_denoising(image, positive=positive)
    got = tw.apply_wavelet_denoising(image, positive=positive)
    assert got.dtype == ref.dtype
    assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# StarletMorphology, StarletSource
# ---------------------------------------------------------------------------
def _thresholds(morph):
    """The per-scale thresholds of a morphology's L0 constraint: (J + 1,)."""
    t = morph.parameters[0].constraint.constraints[1].thresh
    t = np.asarray(t)
    return t.reshape(len(t), -1)[:, 0]


def _same_source(js, ts):
    assert ts.bbox == js.bbox
    assert ts.children[1].bbox == js.children[1].bbox
    for jp, tp in zip(js.parameters, ts.parameters):
        assert jp.name == tp.name and jp.shape == tp.shape
        ref = np.asarray(jp.value)
        err = np.abs(tp.value.numpy() - ref).max()
        assert err <= 1e-6 * np.abs(ref).max(), (jp.name, err)
    assert_allclose(ts.get_model().numpy(), np.asarray(js.get_model()),
                    rtol=0, atol=1e-6 * np.abs(js.get_model()).max())


@pytest.fixture(scope="module")
def pair():
    return _pair(0)


@pytest.mark.parametrize("kind", ["seed", "full_frame", "spectrum"])
def test_starlet_source_matches_jax(pair, kind):
    jframe, jobs, tframe, tobs, centers = pair
    kw = dict(starlet_thresh=5e-3)
    if kind == "seed":
        js = st.StarletSource(jframe, centers[0], jobs, **kw)
        ts = tm.StarletSource(tframe, centers[0], tobs, **kw)
    elif kind == "full_frame":
        np.random.seed(0)
        js = st.StarletSource(jframe, **kw)
        np.random.seed(0)
        ts = tm.StarletSource(tframe, **kw)
    else:
        spec = np.array([1.0, 2.0, 0.5])
        js = st.StarletSource(jframe, centers[1], [jobs], spectrum=spec, **kw)
        ts = tm.StarletSource(tframe, centers[1], [tobs], spectrum=spec, **kw)
        step_j = js.children[0].parameters[0].step
        step_t = ts.children[0].parameters[0].step
        assert_allclose(step_t.keywords["minimum"],
                        step_j.keywords["minimum"], rtol=1e-12)
    _same_source(js, ts)
    tt, jt = _thresholds(ts.children[1]), _thresholds(js.children[1])
    assert tt[-1] == jt[-1] == 0
    assert _ulps(tt[:-1], jt[:-1]).max() <= NORM_ULPS
    if kind == "full_frame":
        assert ts.bbox.shape == (3, 40, 40)
        assert ts.parameters[1].shape == (5, 40, 40)


def test_monotonic_starlet_morphology(pair):
    jframe, jobs, tframe, tobs, centers = pair
    js = st.StarletSource(jframe, centers[0], jobs, monotonic=True)
    ts = tm.StarletSource(tframe, centers[0], tobs, monotonic=True)
    _same_source(js, ts)
    jc, tc = js.parameters[1].constraint, ts.parameters[1].constraint
    assert isinstance(tc, tm.MonotonicMaskConstraint)
    assert tc.center == jc.center and tc.center_radius == jc.center_radius
    x = np.abs(np.asarray(js.parameters[1].value))
    tcon.reset_mask_constraint_counts()
    assert_array_equal(tc(_t(x), 0.1).numpy(), np.asarray(jc(x, 0.1)))
    assert tcon.mask_constraint_counts() == dict(calls=1, planes=len(x))


def _gaussian_cut(size=41, radius=6, sigma=3.0):
    yy, xx = np.mgrid[:size, :size] - size // 2
    g = np.exp(-(yy ** 2 + xx ** 2) / (2 * sigma ** 2))
    g[yy ** 2 + xx ** 2 > radius ** 2] = 0
    return g


def test_shrink_keeps_fitting_where_jax_raises():
    """A 41 x 41 StarletMorphology whose reconstruction is 0 beyond a
    radius of 6 shrinks to 21 x 21; the port's thresholds follow the new
    box, the JAX package's (J + 1, 41, 41) array raises on the first prox
    (ROADMAP Queue 3)."""
    g = _gaussian_cut()
    jm = st.StarletMorphology(st.Frame((1, 64, 64), channels=["r"]), g,
                              bbox=st.Box((41, 41), origin=(12, 12)),
                              threshold=0.1)
    tmorph = tm.StarletMorphology(tm.Frame((1, 64, 64), channels=["r"]), g,
                                  bbox=Box((41, 41), origin=(12, 12)),
                                  threshold=0.1)
    p0 = tmorph.parameters[0]
    p0.m = torch.full(p0.shape, 0.5, dtype=torch.float64)
    p0.v = torch.full(p0.shape, 0.25, dtype=torch.float64)
    before = _thresholds(tmorph)
    for m in (jm, tmorph):
        with pytest.raises((st.UpdateException, tm.UpdateException)):
            m.update()
    assert tmorph.bbox == Box((21, 21), origin=(22, 22))
    assert (jm.bbox.shape, jm.bbox.origin) == ((21, 21), (22, 22))
    p = tmorph.parameters[0]
    assert p.shape == (5, 21, 21) and p.m.shape == p.v.shape == p.shape
    assert p.vhat is None
    assert_array_equal(p.value.numpy(), np.asarray(
        jm.parameters[0].value))
    out = p.constraint(p.value, 0.1)
    assert tuple(out.shape) == (5, 21, 21)
    assert_array_equal(_thresholds(tmorph), before)
    jp = jm.parameters[0]
    with pytest.raises(TypeError):
        jp.constraint(jp.value, 0.1)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------
def _sources(pkg, frame, obs, centers, monotonic=False):
    return [pkg.StarletSource(frame, centers[0], obs, monotonic=monotonic,
                              starlet_thresh=5e-3)] + [
        pkg.SingleExtendedSource(frame, c, obs) for c in centers[1:]]


def test_starlet_fit_matches_jax(pair):
    """Each package initializes its own sources and fits N_ITER
    iterations."""
    jframe, jobs, tframe, tobs, centers = pair
    jb = st.Blend(_sources(st, jframe, jobs, centers), jobs)
    tb = tm.Blend(_sources(tm, tframe, tobs, centers), tobs)
    jb.fit(N_ITER, e_rel=0)
    tb.fit(N_ITER, e_rel=0)
    assert len(tb.loss) == len(jb.loss) == N_ITER
    assert_allclose(tb.loss, jb.loss, rtol=1e-6)
    assert tb.loss[-1] < tb.loss[0]


def _through_callback(constraint):
    """``constraint`` (a host numpy projection) callable inside a JAX
    trace, through ``jax.pure_callback``: the same function on the same
    values."""
    def prox(x, step):
        return jax.pure_callback(
            lambda a, s: np.asarray(constraint(np.asarray(a), s), a.dtype),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x, step)
    return prox


def test_monotonic_starlet_fit_matches_jax(pair):
    """``monotonic=True`` over 3 iterations.  The JAX package's fit traces
    its segment, where the host mask projection cannot run
    (``TracerArrayConversionError``; ROADMAP Queue 3), so the JAX side
    gets its own constraint through ``jax.pure_callback``."""
    jframe, jobs, tframe, tobs, centers = pair
    jsrc = _sources(st, jframe, jobs, centers, monotonic=True)
    tsrc = _sources(tm, tframe, tobs, centers, monotonic=True)
    jb = st.Blend(jsrc, jobs)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jb.fit(1, e_rel=0)
    jp = jsrc[0].children[1].parameters[0]
    jp.constraint = _through_callback(jp.constraint)
    jb = st.Blend(jsrc, jobs)
    jb.fit(3, e_rel=0)
    tcon.reset_mask_constraint_counts()
    tb = tm.Blend(tsrc, tobs)
    tb.fit(3, e_rel=0)
    # one host round trip of all the planes per prox sub-iteration
    J1 = tsrc[0].parameters[1].shape[0]
    assert tcon.mask_constraint_counts() == dict(calls=30, planes=30 * J1)
    assert_allclose(tb.loss, jb.loss, rtol=1e-6)


def test_sources_from_jax_starlet_first_losses(pair):
    jframe, jobs, tframe, tobs, centers = pair
    jsrc = _sources(st, jframe, jobs, centers)
    tsrc = convert.sources_from_jax(jsrc, tframe, device="cpu")
    assert type(tsrc[0]) is tm.StarletSource
    assert type(tsrc[0].children[1]) is tm.StarletMorphology
    assert_array_equal(_thresholds(tsrc[0].children[1]),
                       _thresholds(jsrc[0].children[1]))
    jb, tb = st.Blend(jsrc, jobs), tm.Blend(tsrc, tobs)
    jb.fit(3, e_rel=0)
    tb.fit(3, e_rel=0)
    assert_allclose(tb.loss, jb.loss, rtol=1e-6)


# ---------------------------------------------------------------------------
# interpolate_observation and the pixel-integration helpers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _pair_observations(rotation):
    return _observations(rotation)


@pytest.mark.parametrize("wave_filter", [False, True])
@pytest.mark.parametrize("rotation", [0.0, ROT])
def test_interpolate_observation_matches_jax(rotation, wave_filter):
    """The LR observation resampled onto the HR observation's grid (a
    frame with its own WCS)."""
    (jh, jl), (th, tl) = _pair_observations(rotation)
    ref = np.asarray(jinterp.interpolate_observation(jl, jh, wave_filter))
    got = tinterp.interpolate_observation(tl, th, wave_filter)
    assert got.shape == ref.shape == (1, *th.shape[1:])
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_pixel_integration_helpers_match_jax():
    a, b = np.zeros((3, 7, 9)), np.zeros((11, 4))
    for padding in (None, 3):
        assert tinterp.get_common_padding(a, b, padding) == \
            jinterp.get_common_padding(a, b, padding)
    y, x = np.arange(6.0) - 2.5, np.arange(8.0) * 0.5

    def gauss(fy, fx):
        return np.exp(-(fy[:, None] ** 2 + fx[None, :] ** 2) / 3.0)

    for args in ((4,), (4, 2), (2, 6, 0.8, 0.4)):
        z, fy, fx = tinterp.subsample_function(y, x, gauss, *args)
        jz, jfy, jfx = jinterp.subsample_function(y, x, gauss, *args)
        assert_array_equal(fy, jfy)
        assert_array_equal(fx, jfx)
        assert_array_equal(z, jz)
        got = tinterp.apply_2D_trapezoid_rule(y, x, gauss, *args)
        ref = np.asarray(jinterp.apply_2D_trapezoid_rule(y, x, gauss, *args))
        assert got.shape == ref.shape == (6, 8)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    with pytest.raises(AssertionError):
        tinterp.subsample_function(y, x, gauss, 3)
    for yy, xx in ((np.linspace(-1, 1, 7), np.linspace(-2, 2, 7)),
                   (np.linspace(-1, 1, 12).reshape(3, 4),
                    np.linspace(-2, 2, 20).reshape(4, 5))):
        got = tinterp.sinc2D(yy, xx)
        ref = np.asarray(jinterp.sinc2D(yy, xx))
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
