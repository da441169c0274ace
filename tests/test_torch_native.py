"""The port's host C library (``scarlet_tpu_torch.native``) against its
numpy twins, against the JAX package's ``scarlet_tpu.native`` and on the
port's host paths, on the CPU.

Tolerances: each C function equals its numpy twin bit for bit.  Against
the JAX package's library: the fills, their bounds and orphans, the
orphan fill and the labels bit for bit; the sweep within 2 ulp of float32
(the JAX build, ``-march=native`` without ``-ffp-contract=off``, fuses
each multiply-add and rounds once where the port rounds the product and
the sum) and bit for bit against the port's Jacobi projection;
``apply_filter`` within ``n_values * 2^-23 * sum |v| * max |image|`` (the
same fused multiply-adds, one rounding of each product apart per block
add).  The lite seeds bit for bit against the Jacobi route the port used
before the library, and the JAX package's within the lite tests' 1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu import lite as jlite
from scarlet_tpu import native as jnative
from scarlet_tpu_torch import lite as tlite
from scarlet_tpu_torch import native
from scarlet_tpu_torch.initialization import trim_morphology
from scarlet_tpu_torch.lite import initialization as tinit
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.ops import interpolation
from scarlet_tpu_torch.ops import prox as tprox
from scarlet_tpu_torch.testing import generate_blend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ULP2 = 2 * 2.0 ** -23
# (shape, center): odd, even and non-square boxes; centers in the
# middle, at the edge and corner, and one pixel in from them
CASES = [((15, 17), (7, 8)), ((16, 16), (8, 8)), ((9, 24), (4, 11)),
         ((15, 17), (0, 8)), ((16, 16), (15, 15)), ((9, 24), (1, 22)),
         ((16, 16), (0, 0)), ((9, 24), (8, 1))]

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _profile(shape, center, seed):
    """A noisy peaked float32 profile with negative pixels, its brightest
    pixel at ``center``, and a second bump that the fills must cross."""
    rng = np.random.default_rng(seed)
    H, W = shape
    py, px = center
    yy, xx = np.mgrid[:H, :W]
    prof = np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / (2 * (H / 5) ** 2))
    prof += 0.5 * np.exp(-((yy - (H - 1 - py)) ** 2
                           + (xx - (W - 1 - px)) ** 2) / 4.0)
    out = prof + 0.08 * rng.normal(size=shape)
    out[py, px] = out.max() + 0.5
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def profiles():
    return {(shape, center): _profile(shape, center, 3 + k)
            for k, (shape, center) in enumerate(CASES)}


def _sweep_args(shape, center, nw):
    H, W = shape
    weights = tprox.monotonic_weights(shape, nw, center).reshape(8, -1)
    offsets = np.array([W * dy + dx for dy, dx in tprox.NEIGHBOR_OFFSETS],
                       np.int64)
    didx = tprox.sort_by_radius(shape, center)[1:]
    return weights.astype(np.float32), offsets, didx


def _jacobi(x, shape, center, nw, min_gradient):
    """The port's Jacobi projection at the DAG's depth (float32)."""
    w = tprox.monotonic_weights(shape, nw, center)
    n = tprox.monotonic_depth(w, shape, center)
    return tprox.prox_weighted_monotonic(
        torch.from_numpy(np.array(x)), w, n, min_gradient=min_gradient,
        center=center).numpy()


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nw,min_gradient", [("angle", 0.0), ("flat", 0.1),
                                             ("nearest", 0.05)])
@pytest.mark.parametrize("shape,center", CASES)
def test_sweep_twin_and_jacobi(profiles, shape, center, nw, min_gradient):
    """The C sweep equals its numpy twin and the Jacobi projection bit for
    bit, and the JAX package's library within 2 ulp."""
    x = profiles[(shape, center)]
    weights, offsets, didx = _sweep_args(shape, center, nw)
    got = native.prox_weighted_monotonic(x.reshape(-1).copy(), weights,
                                         offsets, didx, min_gradient)
    twin = native.plain_prox_weighted_monotonic(
        x.reshape(-1).copy(), weights, offsets, didx, min_gradient)
    assert got.dtype == np.float32
    assert_array_equal(got, twin)
    assert_array_equal(got.reshape(shape),
                       _jacobi(x, shape, center, nw, min_gradient))
    assert not np.array_equal(got, x.reshape(-1))
    if jnative.available():
        ref = jnative.prox_weighted_monotonic(
            x.reshape(-1).copy(), weights, offsets, didx, min_gradient)
        assert_allclose(got, ref, rtol=0,
                        atol=F32_ULP2 * np.abs(ref).max())


def test_sweep_in_place_and_empty_image():
    """The sweep writes into a contiguous float32 input and returns it; an
    image with no positive pixel goes through unchanged where every
    reference is below it, as in the twin."""
    shape, center = (11, 13), (5, 6)
    weights, offsets, didx = _sweep_args(shape, center, "angle")
    x = -np.abs(_profile(shape, center, 9)).reshape(-1)
    buf = x.copy()
    out = native.prox_weighted_monotonic(buf, weights, offsets, didx, 0.0)
    assert out is buf
    assert_array_equal(out, native.plain_prox_weighted_monotonic(
        x.copy(), weights, offsets, didx, 0.0))


def test_seq_prox_is_the_c_sweep(profiles):
    """``prox_weighted_monotonic_seq`` is the library's sweep on a copy
    (the caller's image unchanged), for numpy and tensor inputs."""
    shape, center = CASES[0]
    x = profiles[(shape, center)]
    keep = x.copy()
    prox = tprox.prox_weighted_monotonic_seq(shape, "angle", 0.0, center)
    weights, offsets, didx = _sweep_args(shape, center, "angle")
    ref = native.plain_prox_weighted_monotonic(
        x.reshape(-1).copy(), weights, offsets, didx, 0.0).reshape(shape)
    assert_array_equal(prox(x, 0), ref)
    assert_array_equal(prox(torch.from_numpy(x), 0), ref)
    assert_array_equal(x, keep)


# ---------------------------------------------------------------------------
# the fills
# ---------------------------------------------------------------------------
def _fill(mod, image, i, j, variance, thresh):
    unchecked = np.ones(image.shape, np.uint8)
    unchecked[i, j] = 0
    orphans = np.zeros(image.shape, np.uint8)
    bounds = np.array([i, i, j, j], np.int32)
    fill = native.plain_get_valid_monotonic_pixels if mod == "twin" \
        else mod.get_valid_monotonic_pixels
    fill(image, i, j, unchecked, orphans, variance, bounds, thresh)
    return unchecked, orphans, bounds


def _orphan_rounds(mod, image, state, variance, recursive, rounds):
    unchecked, orphans, bounds = (a.copy() for a in state)
    model = np.array(image, np.float32)
    interp = native.plain_linear_interpolate_invalid_pixels \
        if mod == "twin" else mod.linear_interpolate_invalid_pixels
    for _ in range(rounds):
        if not np.any((orphans > 0) & (unchecked > 0)):
            break
        rows, cols = np.where(orphans > 0)
        interp(rows, cols, unchecked, model, orphans, variance, recursive,
               bounds)
    return unchecked, orphans, bounds, model


def _mods():
    return [native, "twin"] + ([jnative] if jnative.available() else [])


@pytest.mark.parametrize("variance,thresh", [(0.0, 0.0), (0.05, 0.0),
                                             (0.0, 0.1)])
@pytest.mark.parametrize("shape,center", CASES)
def test_fill_and_orphans(profiles, shape, center, variance, thresh):
    """The flood fill and three rounds of the orphan fill (recursive and
    not): the C library, its twin and the JAX package's library give the
    same masks, bounds and model bit for bit."""
    x = profiles[(shape, center)]
    i, j = center
    results = [_fill(m, x, i, j, variance, thresh) for m in _mods()]
    for r in results[1:]:
        for a, b in zip(results[0], r):
            assert_array_equal(a, b)
    assert results[0][1].any() or (results[0][0] == 0).sum() > 1
    for recursive in (True, False):
        out = [_orphan_rounds(m, x, results[0], variance, recursive, 3)
               for m in _mods()]
        for r in out[1:]:
            for a, b in zip(out[0], r):
                assert_array_equal(a, b)


def test_fill_of_an_image_with_no_positive_pixel():
    x = -np.abs(_profile((12, 10), (6, 5), 4))
    for m in _mods():
        unchecked, orphans, bounds = _fill(m, x, 6, 5, 0.0, 0.0)
        assert (unchecked == 0).sum() == 1
        assert_array_equal(bounds, [6, 6, 5, 5])
        assert orphans.sum() == 4


@pytest.mark.parametrize("max_iter", [0, 1, 3])
@pytest.mark.parametrize("center_radius,variance", [(1, 0.0), (0, 0.0),
                                                    (2, 0.05)])
def test_prox_monotonic_mask(profiles, max_iter, center_radius, variance):
    """``prox_monotonic_mask`` for every ``max_iter``: the twins composed
    the same way and the JAX package's function, bit for bit; with
    ``max_iter=0`` the mask is ``monotonic_mask_device``'s."""
    from scarlet_tpu.ops import prox as jprox

    for shape, center in CASES[:3]:
        for dtype in (np.float32, np.float64):
            x = profiles[(shape, center)].astype(dtype)
            c = (center[0] + 1, center[1] - 1)
            valid, model, bounds = tprox.prox_monotonic_mask(
                x, 0, c, center_radius, variance, max_iter)
            assert model.dtype == dtype and bounds.dtype == np.int32
            if center_radius > 0:
                i, j = tprox.get_center(x, c, center_radius)
            else:
                i, j = c
            state = _fill("twin", x.astype(np.float32), int(i), int(j),
                          variance, 0.0)
            unchecked, orphans, tb, tm = _orphan_rounds(
                "twin", x.astype(np.float32), state, variance, True,
                max_iter)
            tv = (unchecked == 0) & (orphans == 0)
            assert_array_equal(valid, tv)
            assert_array_equal(model, (tm * tv).astype(dtype))
            assert_array_equal(bounds, tb)
            if jnative.available():
                jv, jm, jb = jprox.prox_monotonic_mask(
                    x, 0, c, center_radius, variance, max_iter)
                assert_array_equal(valid, jv)
                assert_array_equal(model, jm)
                assert_array_equal(bounds, jb)
            if max_iter == 0 and center_radius > 0:
                dv, _ = tprox.monotonic_mask_device(
                    torch.from_numpy(x.astype(np.float32)), torch.tensor(c),
                    center_radius, variance)
                assert_array_equal(valid, dv.numpy())


def test_bindings_check_their_arguments():
    """The C code indexes its arrays unchecked, so the bindings refuse a
    start outside the image, a pixel outside the model, masks of another
    shape and arrays of another dtype or layout."""
    x = _profile((8, 9), (4, 4), 1)
    u, o = np.ones((8, 9), np.uint8), np.zeros((8, 9), np.uint8)
    b = np.array([4, 4, 4, 4], np.int32)
    with pytest.raises(IndexError):
        native.get_valid_monotonic_pixels(x, 8, 4, u, o, 0.0, b)
    with pytest.raises(IndexError):
        native.linear_interpolate_invalid_pixels(
            np.array([1, 9]), np.array([1, 1]), u, x.copy(), o, 0.0, True, b)
    with pytest.raises(ValueError):
        native.get_valid_monotonic_pixels(x, 4, 4, u[:, :8].copy(), o, 0.0,
                                          b)
    with pytest.raises(TypeError):
        native.get_valid_monotonic_pixels(x, 4, 4, u.astype(bool), o, 0.0,
                                          b)
    with pytest.raises(TypeError):
        native.linear_interpolate_invalid_pixels(
            np.array([1]), np.array([1]), u, x.astype(np.float64), o, 0.0,
            True, b)
    with pytest.raises(TypeError):
        native.get_valid_monotonic_pixels(
            x, 4, 4, np.ones((8, 18), np.uint8)[:, ::2], o, 0.0, b)
    weights, offsets, didx = _sweep_args((8, 9), (4, 4), "angle")
    with pytest.raises(IndexError):
        native.prox_weighted_monotonic(x.reshape(-1), weights, offsets,
                                       np.append(didx, 72), 0.0)
    with pytest.raises(IndexError):
        native.apply_filter(x, np.ones(1), [0], [-1], [0], [0])


# ---------------------------------------------------------------------------
# apply_filter and the labels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,ksize", [((20, 22), 5), ((41, 41), 21),
                                         ((9, 30), 7)])
def test_apply_filter(shape, ksize):
    rng = np.random.default_rng(ksize)
    image = rng.normal(size=shape).astype(np.float32)
    kernel = rng.random((ksize, ksize)).astype(np.float32)
    kernel[0, 1] = 0.0
    coords = interpolation.get_filter_coords(kernel)
    bounds = interpolation.get_filter_bounds(coords.reshape(-1, 2))
    values = kernel.reshape(-1)
    got = native.apply_filter(image, values, *bounds)
    assert_array_equal(got, native.plain_apply_filter(image, values,
                                                      *bounds))
    if jnative.available():
        ref = jnative.apply_filter(image, values, *bounds)
        bound = len(values) * 2.0 ** -23 * np.abs(values).sum() * \
            np.abs(image).max()
        assert_allclose(got, ref, rtol=0, atol=bound)


@pytest.mark.parametrize("shape,thresh", [((10, 12), 0.0), ((31, 17), 0.3),
                                          ((16, 16), 10.0)])
def test_label_components(shape, thresh):
    rng = np.random.default_rng(shape[0])
    image = rng.normal(size=shape).astype(np.float32)
    labels, n = native.label_components(image, thresh)
    tl, tn = native.plain_label_components(image, thresh)
    assert (n, labels.dtype) == (tn, np.int32)
    assert_array_equal(labels, tl)
    assert_array_equal(labels > 0, image > thresh)
    assert n == (0 if thresh == 10.0 else labels.max())
    if jnative.available():
        jl, jn = jnative.label_components(image, thresh)
        assert jn == n
        assert_array_equal(labels, jl)


# ---------------------------------------------------------------------------
# the lite seeds
# ---------------------------------------------------------------------------
def _jacobi_monotonic_morph(detect, center, full_box, grow=0, normalize=True,
                            use_mask=True, thresh=0):
    """``init_monotonic_morph(use_mask=False)`` as the port computed it
    before the library: the Jacobi projection at ``monotonic_depth``
    passes in ``detect``'s dtype."""
    assert not use_mask
    detect = to_numpy(detect)
    weights = tprox.monotonic_weights(detect.shape, "angle", center)
    n_iter = tprox.monotonic_depth(weights, detect.shape, center)
    morph = tprox.prox_weighted_monotonic(
        torch.from_numpy(np.ascontiguousarray(detect)), weights, n_iter,
        min_gradient=0, center=center).numpy()
    morph, bbox = trim_morphology(center, morph, bg_thresh=thresh)
    if np.max(morph) == 0:
        return tinit.Box((0, 0, 0)), None
    if normalize:
        morph = morph / np.max(morph)
    return bbox, morph


def _obs(lite, d):
    weights = (1.0 / np.maximum(d["variance"], 1e-12)).astype(np.float32)
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    noise_rms = np.sqrt(d["variance"].astype(np.float64)).mean(
        axis=(1, 2)).astype(np.float32)
    kw = {"device": "cpu"} if lite is tlite else {}
    return lite.LiteObservation(d["images"], d["variance"], weights,
                                d["psfs"], model_psf=model_psf,
                                noise_rms=noise_rms, **kw)


@pytest.fixture(scope="module")
def blends():
    return [generate_blend(np.random.default_rng(s)) for s in (0, 5)]


def _detect(d):
    det = np.sum(d["images"] / d["variance"].mean(axis=(1, 2))[:, None,
                                                                None],
                 axis=0)
    centers = [(int(round(r["y"])), int(round(r["x"])))
               for r in d["catalog"]]
    return det, centers


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_monotonic_morph(blends, dtype):
    """The seeds of every catalog center: float32 bit for bit with the
    Jacobi route; in both dtypes in ``detect``'s dtype and within 1e-5 of
    the JAX package's (its native sweep, float32 cast back).  A float64
    ``detect`` is projected in float32, as in the JAX package, so its
    seed is float32 values in a float64 array, which the float64 Jacobi
    route is not."""
    for d in blends:
        det, centers = _detect(d)
        det = det.astype(dtype)
        full_box = tinit.Box(det.shape)
        for c in centers:
            for thresh in (0.0, 0.5):
                bbox, morph = tinit.init_monotonic_morph(
                    det, c, full_box, normalize=False, use_mask=False,
                    thresh=thresh)
                jbox, jmorph = jlite.init_monotonic_morph(
                    det, c, full_box, normalize=False, use_mask=False,
                    thresh=thresh)
                pbox, pmorph = _jacobi_monotonic_morph(
                    det, c, full_box, normalize=False, use_mask=False,
                    thresh=thresh)
                if morph is None:
                    assert jmorph is None
                    continue
                assert morph.dtype == dtype
                assert bbox.shape == jbox.shape and \
                    bbox.origin == jbox.origin
                assert_allclose(morph, np.asarray(jmorph), rtol=1e-5,
                                atol=1e-5 * np.abs(morph).max())
                assert_array_equal(morph.astype(np.float32).astype(dtype),
                                   morph)
                if dtype == np.float32:
                    assert bbox.shape == pbox.shape and \
                        bbox.origin == pbox.origin
                    assert_array_equal(morph, pmorph)


def _seeds(sources):
    return [(tuple(c.bbox.shape), tuple(c.bbox.origin), to_numpy(c.sed),
             to_numpy(c.morph)) for s in sources for c in s.components]


def test_init_all_sources_main(blends, monkeypatch):
    """The scarlet-main recipe's seeds: bit for bit with the Jacobi route
    and within the lite tests' 1e-5 of the JAX package's."""
    for d in blends:
        centers = [(int(round(r["y"])), int(round(r["x"])))
                   for r in d["catalog"]]
        got = _seeds(tlite.init_all_sources_main(_obs(tlite, d), centers,
                                                 min_snr=50))
        ref = _seeds(jlite.init_all_sources_main(_obs(jlite, d), centers,
                                                 min_snr=50))
        with monkeypatch.context() as m:
            m.setattr(tinit, "init_monotonic_morph", _jacobi_monotonic_morph)
            old = _seeds(tlite.init_all_sources_main(_obs(tlite, d),
                                                     centers, min_snr=50))
        assert len(got) == len(old) == len(ref)
        for g, o, r in zip(got, old, ref):
            assert g[:2] == o[:2] == r[:2]
            assert_array_equal(g[2], o[2])
            assert_array_equal(g[3], o[3])
            assert_allclose(g[2], np.asarray(r[2]), rtol=1e-5, atol=1e-5)
            assert_allclose(g[3], np.asarray(r[3]), atol=1e-5)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
def _run(code, env, timeout=120):
    env = dict(os.environ, **env)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


_CALL = """
    import numpy as np
    from scarlet_tpu_torch.ops import prox
    x = np.ones((5, 5), np.float32)
    try:
        out = prox.prox_monotonic_mask(x, 0, (2, 2))
    except RuntimeError as e:
        print("RAISED", e)
    else:
        print("RETURNED", out)
"""


def test_library_is_built_without_contraction():
    from scarlet_tpu_torch.native import build

    assert "-ffp-contract=off" in build.FLAGS
    assert not any(f.startswith("-march") for f in build.FLAGS)
    assert native.available()


def test_missing_or_failing_compiler_raises(tmp_path):
    """A missing compiler, or one that fails, raises with its message: no
    path returns a numpy result in the library's place."""
    missing = _run(_CALL, {"CXX": str(tmp_path / "no-such-c++"),
                           "SCARLET_NATIVE_BUILD_DIR": str(tmp_path / "a")})
    assert missing.returncode == 0, missing.stderr
    assert missing.stdout.startswith("RAISED"), missing.stdout
    assert "not found" in missing.stdout
    broken = tmp_path / "broken-c++"
    broken.write_text("#!/bin/sh\nif [ \"$1\" = --version ]; then echo "
                      "broken 1.0; exit 0; fi\necho 'kernels.cc: error: "
                      "no compiler here' >&2\nexit 1\n")
    broken.chmod(0o755)
    failed = _run(_CALL, {"CXX": str(broken),
                          "SCARLET_NATIVE_BUILD_DIR": str(tmp_path / "b")})
    assert failed.returncode == 0, failed.stderr
    assert failed.stdout.startswith("RAISED"), failed.stdout
    assert "no compiler here" in failed.stdout
    assert not list((tmp_path / "b").glob("*.so"))


def test_concurrent_builds_both_load(tmp_path):
    """Two processes building into one empty directory at once both load
    a whole library; one file is left, and no temporary directory."""
    code = """
        import numpy as np
        from scarlet_tpu_torch import native
        labels, n = native.label_components(
            np.array([[1, 0, 1], [1, 0, 0]], np.float32))
        print("LABELS", n)
    """
    env = dict(os.environ, SCARLET_NATIVE_BUILD_DIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "LABELS 2"
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]
