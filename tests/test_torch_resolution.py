"""The port's multi-resolution building blocks against the JAX package on
the CPU: WCS, frames, interpolation, Fourier shifts, PSF models, renderer
selection, the renderers' precomputed operators and their renders.

Inputs: the synthetic two-instrument Gaussian scene of
``tests/test_multiresolution.py:make_pair`` at small widths (HR 32 x 32 at
0.1", LR 12 x 12 at 0.3", aligned or rotated by 28 degrees), built on both
sides from the same numpy arrays.

Tolerances: WCS and pixel maps 1e-9 (pixels or degrees); interpolation,
shifts and PSF models 1e-6 of the largest value; precomputed operators
1e-6 and renders 1e-5 of the largest value.  The PSF images are dyadic
(multiples of 2^-20 summing to exactly 1) and float64, so that their
normalization, a float32 sum whose order XLA and torch choose
differently, is exact on both sides, and the JAX package transforms them
in float64: the difference kernels deconvolve by the model PSF, and that
division amplifies a last-bit difference of the PSFs to ~1e-4 of the
same-scale kernel (ROADMAP Queue 3, traps).  Operators and renders are
compared with both model frames in float64 (the JAX package then
computes them in float64 too); the port's float32 render, the fitter's
precision, is held against the JAX float64 render.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import scarlet_tpu as st
from scarlet_tpu.ops import fft as jfft
from scarlet_tpu.ops import interpolation as jint
from scarlet_tpu.utils import make_tan_wcs as jwcs
from scarlet_tpu_torch import convert
from scarlet_tpu_torch import models as tm
from scarlet_tpu_torch.ops import fft as tfft
from scarlet_tpu_torch.ops import interpolation as tint
from scarlet_tpu_torch.testing.multires import (BLOBS, DEC0, RA0,
                                                SIGMA_PSF_HR, SIGMA_PSF_LR,
                                                gaussian_image)
from scarlet_tpu_torch.utils import AffineWCS, make_tan_wcs as twcs

ROT = np.deg2rad(28)
SMALL = ((32, 32), (12, 12))
FULL = ((64, 64), (24, 24))


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def _dyadic(psf):
    """``psf`` rounded to multiples of 2^-20 summing to exactly 1 (the
    residue on the peak), float64: exact in float32 too, and its sum is
    exact in any order and either precision."""
    q = np.round(psf.astype(np.float64) * 2 ** 20)
    q[np.unravel_index(np.argmax(q), q.shape)] += 2 ** 20 - q.sum()
    return q / 2 ** 20


def _arrays(rotation, widths=SMALL):
    """Images and dyadic PSFs of the two instruments (numpy)."""
    shape_hr, shape_lr = widths
    crval = (RA0, DEC0)
    w_hr = twcs(0.1, shape_hr, crval=crval)
    w_lr = twcs(0.3, shape_lr, crval=crval, rotation=rotation)

    def observed(sp):
        return [(f, bx, by, np.hypot(s, sp)) for f, bx, by, s in BLOBS]

    def psf(scale, sigma, rot=0.0):
        wcs = twcs(scale, (21, 21), crval=crval, rotation=rot)
        return _dyadic(gaussian_image(wcs, (21, 21), [(1.0, 0, 0, sigma)],
                                      scale)[None])

    return dict(
        hr=(gaussian_image(w_hr, shape_hr, observed(SIGMA_PSF_HR), 0.1),
            psf(0.1, SIGMA_PSF_HR), (0.1, shape_hr, 0.0)),
        lr=(gaussian_image(w_lr, shape_lr, observed(SIGMA_PSF_LR), 0.3),
            psf(0.3, SIGMA_PSF_LR, rotation), (0.3, shape_lr, rotation)))


def _observations(rotation, widths=SMALL):
    """((jax hr, jax lr), (port hr, port lr)) of the same arrays."""
    out = []
    for obs_cls, psf_cls, make_wcs, kw in (
            (st.Observation, st.ImagePSF, jwcs, {}),
            (tm.Observation, tm.ImagePSF, twcs, dict(device="cpu"))):
        pair = []
        for name, (data, psf, (scale, shape, rot)) in _arrays(
                rotation, widths).items():
            wcs = make_wcs(scale, shape, crval=(RA0, DEC0), rotation=rot)
            pair.append(obs_cls(data[None], wcs=wcs, psf=psf_cls(psf),
                                channels=[name], **kw))
        out.append(tuple(pair))
    return tuple(out)


def _frames(rotation, coverage="union", widths=SMALL):
    (jh, jl), (th, tl) = _observations(rotation, widths)
    jf = st.Frame.from_observations([jl, jh], obs_id=1, coverage=coverage)
    tf = tm.Frame.from_observations([tl, th], obs_id=1, coverage=coverage)
    return (jf, jh, jl), (tf, th, tl)


def _to_float64(frame, observations):
    frame.dtype = np.float64
    for obs in observations:
        obs.match(frame)


def _scene(frame, B=None, seed=0):
    shape = tuple(frame.shape) if B is None else (B, *frame.shape)
    return np.random.default_rng(seed).random(shape)


# ---------------------------------------------------------------------------
# WCS and frames
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rotation", [0.0, ROT])
def test_wcs_round_trip(rotation):
    j = jwcs(0.3, (12, 12), crval=(RA0, DEC0), rotation=rotation)
    t = twcs(0.3, (12, 12), crval=(RA0, DEC0), rotation=rotation)
    pix = np.random.default_rng(1).uniform(-3, 15, (50, 2))
    world = t.pixel_to_world_values(pix)
    assert np.abs(world - j.pixel_to_world_values(pix)).max() <= 1e-9
    assert np.abs(t.world_to_pixel_values(world) - pix).max() <= 1e-9
    assert np.abs(t.world_to_pixel_values(world)
                  - j.world_to_pixel_values(world)).max() <= 1e-9
    assert_array_equal(t.wcs.pc, j.wcs.pc)
    assert_array_equal(t.cd, j.cd)
    copy = t.deepcopy()
    copy.wcs.crpix -= 1
    assert t.wcs.crpix[0] == j.wcs.crpix[0]
    a = AffineWCS(crpix=(3, 4), crval=(RA0, DEC0), pc=np.eye(2),
                  cdelt=(1e-4, 2e-4))
    assert np.abs(a.world_to_pixel_values(a.pixel_to_world_values(pix))
                  - pix).max() <= 1e-9


@pytest.mark.parametrize("rotation", [0.0, ROT])
def test_frame_pixel_maps(rotation):
    (jf, jh, jl), (tf, th, tl) = _frames(rotation)
    sky = [(RA0 + 1e-4, DEC0 - 2e-4), (RA0, DEC0)]
    assert np.abs(tf.get_pixel(sky) - jf.get_pixel(sky)).max() <= 1e-9
    assert np.abs(tf.get_pixel(sky[0]) - jf.get_pixel(sky[0])).max() <= 1e-9
    pix = [(3.5, 7.25), (0.0, 0.0)]
    assert np.abs(tf.get_sky_coord(pix)
                  - jf.get_sky_coord(pix)).max() <= 1e-9
    assert np.abs(tl.convert_pixel_to(tf) - jl.convert_pixel_to(jf)).max() \
        <= 1e-9
    assert np.abs(tf.convert_pixel_to(th, pixel=(10.0, 20.0))
                  - jf.convert_pixel_to(jh, pixel=(10.0, 20.0))).max() <= 1e-9


@pytest.mark.parametrize("rotation", [0.0, ROT])
@pytest.mark.parametrize("coverage", ["union", "intersection"])
def test_from_observations(rotation, coverage):
    """At the full widths (HR 64 x 64, LR 24 x 24)."""
    (jf, jh, jl), (tf, th, tl) = _frames(rotation, coverage, FULL)
    assert tuple(tf.shape) == tuple(jf.shape)
    assert (tf.bbox.shape, tf.bbox.origin) == (jf.bbox.shape, jf.bbox.origin)
    assert list(tf.channels) == list(jf.channels)
    assert_array_equal(tf.wcs.wcs.crpix, jf.wcs.wcs.crpix)
    assert tf.wcs.array_shape == jf.wcs.array_shape
    _close(tf.psf.get_model(), jf.psf.get_model(), 1e-6)
    for t, j in ((th, jh), (tl, jl)):
        assert type(t.renderer).__name__ == type(j.renderer).__name__


def test_small_rotated_intersection_raises_like_jax():
    """At HR 32 x 32 the rotated intersection frame is smaller than the
    upsampled difference kernel: both packages refuse to pad it."""
    (jh, jl), (th, tl) = _observations(ROT)
    with pytest.raises(ValueError):
        st.Frame.from_observations([jl, jh], obs_id=1,
                                   coverage="intersection")
    with pytest.raises(ValueError, match="smaller than newshape"):
        tm.Frame.from_observations([tl, th], obs_id=1,
                                   coverage="intersection")


def test_from_observations_upsamples_the_model_psf():
    """The LR PSF as the model PSF on the HR grid: sinc-upsampled."""
    for rotation in (0.0, ROT):
        (jh, jl), (th, tl) = _observations(rotation)
        jf = st.Frame.from_observations([jl, jh], obs_id=0,
                                        model_wcs=jh.wcs)
        tf = tm.Frame.from_observations([tl, th], obs_id=0,
                                        model_wcs=th.wcs)
        assert tuple(tf.shape) == tuple(jf.shape)
        assert tf.psf.get_model().shape[-1] > tl.psf.get_model().shape[-1]
        _close(tf.psf.get_model(), jf.psf.get_model(), 1e-6)


# ---------------------------------------------------------------------------
# Interpolation, shifts, PSF models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rotation", [0.0, 0.3, ROT])
def test_get_angles_and_psf_size(rotation):
    a = jwcs(0.1, (32, 32), crval=(RA0, DEC0))
    b = jwcs(0.3, (12, 12), crval=(RA0, DEC0), rotation=rotation)
    ta = twcs(0.1, (32, 32), crval=(RA0, DEC0))
    tb = twcs(0.3, (12, 12), crval=(RA0, DEC0), rotation=rotation)
    (jc, js), jh = jint.get_angles(b, a)
    (tc, ts), th = tint.get_angles(tb, ta)
    assert abs(tc - jc) <= 1e-12 and abs(ts - js) <= 1e-12
    assert abs(th - jh) <= 1e-12
    psf = _arrays(rotation)["lr"][1][0]
    assert tint.get_psf_size(torch.from_numpy(psf)) == jint.get_psf_size(psf)
    assert tint.get_pixel_size(tint.get_affine(tb)) == \
        jint.get_pixel_size(jint.get_affine(b))


@pytest.mark.parametrize("kernel", ["bilinear", "cubic_spline",
                                    "catmull_rom", "mitchel_netravali",
                                    "lanczos", "quintic_spline"])
@pytest.mark.parametrize("dx", [-0.75, -0.2, 0.0, 0.35, 1.0])
def test_1d_kernels(kernel, dx):
    for got, ref in zip(getattr(tint, kernel)(dx), getattr(jint, kernel)(dx)):
        assert_array_equal(got, ref)
    for got, ref in zip(tint.get_separable_kernel(dx, 0.3),
                        jint.get_separable_kernel(dx, 0.3)):
        assert_array_equal(got, ref)


def test_filter_geometry_and_projections():
    coords = tint.get_filter_coords(np.ones((5, 7)))
    assert_array_equal(coords, jint.get_filter_coords(np.ones((5, 7))))
    assert_array_equal(tint.get_filter_coords(np.ones((4, 4)), (1, 2)),
                       jint.get_filter_coords(np.ones((4, 4)), (1, 2)))
    for got, ref in zip(tint.get_filter_bounds(coords.reshape(-1, 2)),
                        jint.get_filter_bounds(coords.reshape(-1, 2))):
        assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tint.get_filter_coords(np.ones((4, 5)))
    image = np.random.default_rng(9).random((5, 8))
    for shape, yx0 in (((9, 12), None), ((3, 4), None), ((9, 12), (-1, 2))):
        assert tint.get_projection_slices(image, shape, yx0) == \
            jint.get_projection_slices(image, shape, yx0)
        assert_array_equal(
            tint.project_image(torch.from_numpy(image), shape, yx0).numpy(),
            np.asarray(jint.project_image(image, shape, yx0)))
    other = np.random.default_rng(10).random((7, 3))
    for got, ref in zip(tint.common_projections(torch.from_numpy(image),
                                                torch.from_numpy(other)),
                        jint.common_projections(image, other)):
        assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("angle", [None, (np.cos(ROT), np.sin(ROT))])
def test_sinc_interp(angle):
    # square, as the PSFs it upsamples: the aligned form contracts the
    # rows' sinc matrix with the columns (both packages)
    rng = np.random.default_rng(2)
    images = rng.random((2, 9, 9))
    coord_lr = (np.arange(9) - 4.0, np.arange(9) - 4.0)
    coord_hr = (np.arange(25) / 3 - 4, np.arange(25) / 3 - 4)
    ref = np.asarray(jint.sinc_interp(images, coord_hr, coord_lr,
                                      angle=angle))
    got = tint.sinc_interp(torch.from_numpy(images), coord_hr, coord_lr,
                           angle=angle)
    assert got.dtype == torch.float64
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("angle", [(1.0, 0.0), (np.cos(ROT), np.sin(ROT))])
def test_sinc_interp_inplace(angle):
    psf = _arrays(0.0)["lr"][1].astype(np.float64)
    ref = np.asarray(jint.sinc_interp_inplace(psf, 0.3, 0.1, angle,
                                              pad_shape=(33, 33)))
    got = tint.sinc_interp_inplace(torch.from_numpy(psf), 0.3, 0.1, angle,
                                   pad_shape=(33, 33))
    _close(got, ref, 1e-6)


def test_mk_shifter_and_shift():
    for shape, real in (((12, 10), False), ((15, 16), True)):
        for j, t in zip(jfft.mk_shifter(shape, real=real),
                        tfft.mk_shifter(shape, real=real)):
            assert t.dtype == torch.complex128
            assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-15)
    image = np.random.default_rng(3).random((2, 17, 17)).astype(np.float32)
    for s in ((0.3, -0.7), (2.0, 1.5)):
        ref = np.asarray(jfft.shift(image, np.asarray(s, np.float32),
                                    return_fourier=False))
        got = tfft.shift(torch.from_numpy(image),
                         torch.tensor(s, dtype=torch.float32),
                         return_fourier=False)
        _close(got, ref, 1e-6)
        # a batch axis in front shifts each image alike
        batched = tfft.shift(torch.from_numpy(image)[None],
                             torch.tensor(s), return_fourier=False)
        _close(batched[0], got, 1e-12)


@pytest.mark.parametrize("kind", ["gauss_same", "gauss_each", "gauss_plain",
                                  "moffat", "image"])
@pytest.mark.parametrize("offset", [None, (0.25, -0.4)])
def test_psf_models(kind, offset):
    if kind == "gauss_same":
        j, t = st.GaussianPSF([0.9, 0.9]), tm.GaussianPSF([0.9, 0.9])
    elif kind == "gauss_each":
        j, t = st.GaussianPSF([0.7, 1.3]), tm.GaussianPSF([0.7, 1.3])
    elif kind == "gauss_plain":
        j = st.GaussianPSF([1.1], integrate=False, boxsize=12)
        t = tm.GaussianPSF([1.1], integrate=False, boxsize=12)
    elif kind == "moffat":
        j, t = st.MoffatPSF([3.0, 4.0], [1.5, 2.0]), \
            tm.MoffatPSF([3.0, 4.0], [1.5, 2.0])
    else:
        image = _arrays(0.0)["hr"][1]
        j, t = st.ImagePSF(image), tm.ImagePSF(image)
    ref = np.asarray(j.get_model(offset=offset))
    got = t.get_model(offset=offset)
    _close(got, ref, 1e-6)
    assert (t.bbox.shape, t.bbox.origin) == (j.bbox.shape, j.bbox.origin)
    _close(tm.normalize(got), np.asarray(st.models.normalize(ref)), 1e-6)


# ---------------------------------------------------------------------------
# Renderer selection and precomputed operators
# ---------------------------------------------------------------------------
def test_match_picks_the_renderer():
    (jf, jh, jl), (tf, th, tl) = _frames(ROT)
    assert type(th.renderer) is tm.ConvolutionRenderer     # deep-copied WCS
    assert type(tl.renderer) is tm.ResolutionRenderer and tl.renderer.isrot
    (_, _, jl0), (_, _, tl0) = _frames(0.0)
    assert type(tl0.renderer) is tm.ResolutionRenderer
    assert not tl0.renderer.isrot and not jl0.renderer.isrot
    # the same PSF object: no transform; the same WCS object: convolution
    for pkg, frame in ((st, jf), (tm, tf)):
        kw = {} if pkg is st else dict(device="cpu")
        data = np.zeros(frame.shape, np.float32)
        null = pkg.Observation(data, channels=frame.channels, psf=frame.psf,
                               wcs=frame.wcs, **kw).match(frame)
        conv = pkg.Observation(data, channels=frame.channels,
                               psf=pkg.GaussianPSF([2.0, 2.0]),
                               wcs=frame.wcs, **kw).match(frame)
        assert type(null.renderer).__name__ == "NullRenderer"
        assert type(conv.renderer).__name__ == "ConvolutionRenderer"
        assert null.renderer.channel_map is None
    assert tl.renderer.channel_map == jl.renderer.channel_map == slice(0, 1)


@pytest.mark.parametrize("rotation", [0.0, ROT])
def test_precomputed_operators(rotation):
    (jf, jh, jl), (tf, th, tl) = _frames(rotation)
    _to_float64(jf, (jh, jl))
    _to_float64(tf, (th, tl))
    jr, tr = jh.renderer, th.renderer
    assert jr._fft_shape == tr._fft_shape
    assert jr.slices == tr.slices
    _close(tr.diff_kernel.image, jr.diff_kernel.image, 1e-6)
    _close(tr._kernel_rfft, jr._kernel_rfft, 1e-6)
    jr, tr = jl.renderer, tl.renderer
    assert jr._fft_shape == tr._fft_shape
    assert tr.h == jr.h and tr.angle == jr.angle
    _close(tr._diff_kernel, jr._diff_kernel, 1e-6)
    if rotation == 0.0:
        _close(tr._P_y, jr._P_y, 1e-6)
        _close(tr._P_x, jr._P_x, 1e-6)
        _close(tr._kernel_rfft, jr._kernel_rfft, 1e-6)
    else:
        # the JAX stack is (Ny, C, V) rolled by fftshift; the port's is
        # (C, Ny, V) in FFT order
        Ny = jr._A.shape[0]
        A = np.fft.ifftshift(np.asarray(jr._A).reshape(
            Ny, -1, *jr._fft_shape), axes=(-2, -1)).reshape(Ny, -1,
                                                           tr._A.shape[-1])
        _close(tr._A, A.transpose(1, 0, 2), 1e-6)


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------
def _render_pair(kind):
    """(jax observation, port observation, model frames) of one render
    kind, both frames float64."""
    rotation = ROT if kind == "resolution_rotated" else 0.0
    (jf, jh, jl), (tf, th, tl) = _frames(rotation)
    _to_float64(jf, (jh, jl))
    _to_float64(tf, (th, tl))
    if kind in ("resolution_aligned", "resolution_rotated"):
        return jl, tl
    if kind == "convolution_fft":
        return jh, th
    if kind == "convolution_real":
        jh.match(jf, renderer=st.ConvolutionRenderer(
            jh, jf, convolution_type="real"))
        th.match(tf, renderer=tm.ConvolutionRenderer(
            th, tf, convolution_type="real"))
        return jh, th
    pair = []
    for pkg, frame, kw in ((st, jf, {}), (tm, tf, dict(device="cpu"))):
        pair.append(pkg.Observation(
            np.zeros(frame.shape), channels=frame.channels, psf=frame.psf,
            wcs=frame.wcs, **kw).match(frame))
    return tuple(pair)


KINDS = ["null", "convolution_fft", "convolution_real",
         "resolution_aligned", "resolution_rotated"]


@pytest.mark.parametrize("kind", KINDS)
def test_render_float64(kind):
    jo, to = _render_pair(kind)
    scene = _scene(jo.model_frame)
    ref = np.asarray(jo.render(scene))
    got = to.render(torch.from_numpy(scene))
    assert got.dtype == torch.float64
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_render_batch_and_float32(kind):
    """A (B, C, H, W) batch renders like its items; the fitter's float32
    render stays within 1e-5 of the JAX float64 render."""
    jo, to = _render_pair(kind)
    scenes = _scene(jo.model_frame, B=3, seed=4)
    ref = np.stack([np.asarray(jo.render(s)) for s in scenes])
    got = to.render(torch.from_numpy(scenes))
    _close(got, ref, 1e-5)
    for b in range(3):
        _close(to.render(torch.from_numpy(scenes[b])), got[b], 1e-12)
    frame = to.model_frame
    frame.dtype = np.float32
    to.match(frame, renderer=None if kind != "convolution_real" else
             tm.ConvolutionRenderer(to, frame, convolution_type="real"))
    got32 = to.render(torch.from_numpy(scenes.astype(np.float32)))
    assert got32.dtype == torch.float32
    _close(got32, ref, 1e-5)


def test_render_autograd_matches_jax():
    """Gradients of a weighted square loss through the LR renderer."""
    import jax

    for rotation in (0.0, ROT):
        (jf, jh, jl), (tf, th, tl) = _frames(rotation)
        _to_float64(jf, (jh, jl))
        _to_float64(tf, (th, tl))
        scene = _scene(jf, seed=5)
        y = np.random.default_rng(6).random(jl.shape)
        ref = np.asarray(jax.grad(
            lambda s: ((jl.render(s) - y) ** 2).sum())(scene))
        x = torch.from_numpy(scene).requires_grad_()
        ((tl.render(x) - torch.from_numpy(y)) ** 2).sum().backward()
        _close(x.grad, ref, 1e-5)


def test_mixing_matrix_channel_map():
    """A (C_obs, C_model) mixing matrix contracts the channel axis.  The
    JAX package's ``np.dot`` contracts the row axis instead and raises for
    any frame with H != C (ROADMAP Queue 3): the reference render is the
    JAX renderer of the pre-mixed model."""
    (jf, jh, jl), (tf, th, tl) = _frames(0.0)
    _to_float64(jf, (jh, jl))
    _to_float64(tf, (th, tl))
    mix = np.array([[0.3, 0.7]])
    scene = _scene(jf, seed=7)
    jl.renderer.channel_map = mix
    with pytest.raises(TypeError):
        jl.render(scene)
    jl.renderer.channel_map = None
    ref = np.asarray(jl.render(np.einsum("oc,chw->ohw", mix, scene)))
    tl.renderer.channel_map = mix
    _close(tl.render(torch.from_numpy(scene)), ref, 1e-5)


def test_observation_likelihood_and_frame_projection():
    (jf, jh, jl), (tf, th, tl) = _frames(0.0)
    scene = _scene(jf, seed=8).astype(np.float32)
    for j, t in ((jh, th), (jl, tl)):
        assert_allclose(t.log_norm, j.log_norm, rtol=1e-12)
        assert_allclose(t.noise_rms, j.noise_rms, rtol=1e-7)
        assert_allclose(float(t.get_log_likelihood(torch.from_numpy(scene))),
                        float(j.get_log_likelihood(scene)), rtol=1e-5)
    assert_array_equal(th._to_frame(tf), jh._to_frame(jf))


def test_observations_from_jax_render_like_the_ports_own():
    (jh, jl), (th, tl) = _observations(ROT)
    ch, cl = convert.observations_from_jax((jh, jl), device="cpu")
    f_own = tm.Frame.from_observations([tl, th], obs_id=1)
    f_conv = tm.Frame.from_observations([cl, ch], obs_id=1)
    assert tuple(f_own.shape) == tuple(f_conv.shape)
    assert ch.channels == ["hr"] and cl.weights.dtype == torch.float32
    scene = torch.from_numpy(_scene(f_own, seed=9).astype(np.float32))
    for own, conv in ((th, ch), (tl, cl)):
        assert_array_equal(conv.data.numpy(), own.data.numpy())
        assert_array_equal(conv.render(scene).numpy(),
                           own.render(scene).numpy())
