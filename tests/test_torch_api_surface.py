"""The reference's public surface on the port, the twin of
tests/test_api_surface.py on the CPU: the 56 top-level names (read from
that file), the module namespaces, the ``operator`` namespace on numpy
input, the profiling helpers, ``lite.get_min_psf``,
``ops.fft.fast_zero_pad`` and the generated regression sets, each held
against the JAX package on the same seeded inputs.

Tolerances: the elementwise proxes, the symmetries, ``get_min_psf``,
``fast_zero_pad`` and the generated sets exactly; the monotonic
projection bit for bit against the JAX package run op by op
(``jax.disable_jit()``) and within 2 ulp of its compiled form (XLA
contracts each pass's multiply-add, ROADMAP Queue 3).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax

import scarlet_tpu as jst
import scarlet_tpu_torch as st
import test_api_surface as ref

ULP2 = 2 * 2.0 ** -23


def test_top_level_names():
    missing = [n for n in ref.TOP_LEVEL if not hasattr(st, n)]
    assert not missing, f"missing top-level names: {missing}"
    assert len(ref.TOP_LEVEL) == 56
    for n in ref.TOP_LEVEL:
        where = st.models if hasattr(st.models, n) else st
        assert getattr(st, n) is getattr(where, n), n
    assert st.prepare_param is st.models.prepare_param
    assert st.overlapped_slices is st.bbox.overlapped_slices
    assert st.Cache is st.cache.Cache


def test_module_namespaces():
    """Every namespace of the reference's list, ``display`` and
    ``lite.display`` with the JAX modules' public names (and ``detect``'s
    drawing helpers); ``ops`` with its four modules, ``optim`` and the
    profiling helpers of ``utils``."""
    waiting = set()
    missing = [n for n in ref.MODULES
               if n not in waiting and not hasattr(st, n)]
    assert not missing, f"missing module namespaces: {missing}"
    for port, ref_mod in ((st.display, jst.display),
                          (st.lite.display, jst.lite.display),
                          (st.detect, jst.detect)):
        public = [n for n in dir(ref_mod) if not n.startswith("_")
                  and (callable(getattr(ref_mod, n)) or n == "panel_size")
                  and not isinstance(getattr(ref_mod, n), type(np))]
        assert port.__all__ == ref_mod.__all__
        assert not [n for n in public if not hasattr(port, n)], port
    assert st.display.panel_size == jst.display.panel_size
    for n in ("fft", "interpolation", "prox", "wavelet"):
        assert hasattr(st.ops, n), n
    assert hasattr(st.optim, "adaprox_step")
    for n in ("trace", "annotate", "sync", "timeit"):
        assert hasattr(st.utils, n), n
    assert hasattr(st.lite, "get_min_psf")
    assert hasattr(st.ops.fft, "fast_zero_pad")
    assert hasattr(st.testing, "generate_blend_set")


def _x():
    """The reference check's input (tests/test_api_surface.py:63)."""
    return np.abs(np.random.RandomState(0).randn(11, 11)).astype(np.float32)


def _t(out):
    assert isinstance(out, torch.Tensor)
    return np.asarray(out)


def test_operator_namespace():
    """The reference check, then the projection on its numpy input against
    the JAX package: bit for bit op by op, within 2 ulp jitted."""
    for n in ["sort_by_radius", "prox_weighted_monotonic",
              "prox_monotonic_mask", "prox_cone", "uncentered_operator",
              "prox_sdss_symmetry", "prox_soft_symmetry",
              "prox_kspace_symmetry", "prox_uncentered_symmetry",
              "project_disk_sed", "getOffsets", "diagonalizeArray",
              "getRadialMonotonicWeights"]:
        assert hasattr(st.operator, n), n
    x = _x()
    f = st.operator.build_prox_monotonic((11, 11), neighbor_weight="angle")
    out = _t(f(x))
    assert out.shape == (11, 11) and out.dtype == np.float32
    jf = jst.operator.build_prox_monotonic((11, 11), neighbor_weight="angle")
    with jax.disable_jit():
        assert_array_equal(out, np.asarray(jf(x)))
    jitted = np.asarray(jf(x))
    assert_allclose(out, jitted, rtol=0, atol=ULP2 * np.abs(jitted).max())


@pytest.mark.parametrize("name,args", [
    ("prox_plus", (0,)), ("prox_hard", (1.0,)), ("prox_hard_plus", (1.0,)),
    ("prox_soft", (1.0,)), ("prox_soft_plus", (1.0,)),
    ("prox_sdss_symmetry", ()), ("prox_soft_symmetry", ()),
    ("prox_threshold", ())])
def test_operator_proxes_take_numpy(name, args):
    """Each prox on the numpy input gives the JAX package's values, as a
    tensor of the input's dtype."""
    x = _x() - 0.5
    kw = {"thresh": 0.3} if name in ("prox_hard", "prox_hard_plus",
                                     "prox_soft", "prox_soft_plus") else {}
    out = _t(getattr(st.operator, name)(x, *args, **kw))
    assert out.dtype == x.dtype
    assert_array_equal(out, np.asarray(getattr(jst.operator, name)(
        x, *args, **kw)))


def test_uncentered_symmetry_on_numpy_like_jax():
    """With an off-centre peak the JAX package writes the window back with
    ``X.at``, which a numpy array lacks, and raises; so does the port.
    With a fill, or with the peak at the centre, both run and agree."""
    x = _x()
    peak = np.unravel_index(np.argmax(x), x.shape)
    assert peak != (5, 5)
    with pytest.raises(AttributeError):
        jst.operator.prox_uncentered_symmetry(x)
    with pytest.raises(TypeError, match="JAX package raises here too"):
        st.operator.prox_uncentered_symmetry(x)
    with pytest.raises(AttributeError):
        jst.operator.uncentered_operator(x, jst.operator.prox_sdss_symmetry)
    with pytest.raises(TypeError):
        st.operator.uncentered_operator(x, st.operator.prox_sdss_symmetry)
    for kw in (dict(fill=0.0), dict(center=(5, 5)),
               dict(fill=0.0, algorithm="sdss")):
        out = _t(st.operator.prox_uncentered_symmetry(x, **kw))
        assert_allclose(out, np.asarray(
            jst.operator.prox_uncentered_symmetry(x, **kw)), rtol=0,
            atol=1e-7)


def test_profiling_utils():
    """SURVEY 5.1: the profiler wrapper and synchronized timing."""
    from scarlet_tpu_torch.utils import annotate, sync, timeit

    def f(a):
        return a * 2.0

    t = timeit(f, torch.ones((8, 8)), iters=3, warmup=1)
    assert t >= 0.0
    with annotate("scarlet-test"):
        out = sync({"x": [f(torch.ones((4,)))]})
    assert float(out["x"][0][0]) == 2.0


def test_trace_writes_a_profile(tmp_path):
    from scarlet_tpu_torch.utils import annotate, trace

    with trace(tmp_path):
        with annotate("scarlet-trace"):
            torch.ones(16).sum()
    assert list(tmp_path.glob("*.json"))


@pytest.mark.parametrize("thresh", [0.01, 0.1])
def test_get_min_psf_matches_jax(thresh):
    rng = np.random.default_rng(5)
    psfs = st.testing.generate_blend(rng)["psfs"]
    out = st.lite.get_min_psf(psfs, thresh)
    assert_array_equal(out, jst.lite.get_min_psf(psfs, thresh))
    assert out.shape[-1] < psfs.shape[-1]
    assert_array_equal(st.lite.get_min_psf(torch.from_numpy(psfs), thresh),
                       out)


@pytest.mark.parametrize("widths", [
    ((0, 0), (2, 3), (1, 0)), ((1, 1), (0, 0), (4, 2))])
def test_fast_zero_pad_matches_jax(widths):
    from scarlet_tpu.ops import fft as jfft

    a = np.random.default_rng(1).normal(size=(2, 5, 4)).astype(np.float32)
    out = st.ops.fft.fast_zero_pad(torch.from_numpy(a), widths)
    assert_array_equal(out.numpy(), np.asarray(jfft.fast_zero_pad(a,
                                                                  widths)))
    with pytest.raises(ValueError):
        st.ops.fft.fast_zero_pad(torch.from_numpy(a), ((0, 0), (-1, 0),
                                                       (0, 0)))


def _same_blend(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if a[key].dtype.names:
            assert a[key].dtype == b[key].dtype
            for field in a[key].dtype.names:
                assert_array_equal(a[key][field], b[key][field])
        else:
            assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("set_id", [4, 5, 6, 7, 8])
def test_generate_blend_set_matches_jax(set_id, tmp_path):
    from scarlet_tpu.testing import blendsets as jsets

    ours = st.testing.generate_blend_set(set_id, n=2, root=tmp_path / "t")
    theirs = jsets.generate_blend_set(set_id, n=2, root=tmp_path / "j")
    assert [p.name for p in ours] == [p.name for p in theirs]
    for p, q in zip(ours, theirs):
        with np.load(p) as a, np.load(q) as b:
            _same_blend(dict(a), dict(b))
    # a complete set is reused, not rewritten
    stamp = ours[0].stat().st_mtime_ns
    assert st.testing.generate_blend_set(set_id, n=2, root=tmp_path / "t") \
        == ours
    assert ours[0].stat().st_mtime_ns == stamp


def _tile(seed):
    """A synthetic stand-in for one real HSC tile: a (5, 72, 64) image
    of noise plus two sources, a variance plane, per-band PSFs, catalog
    positions and gains."""
    rng = np.random.default_rng(seed)
    C, H, W = 5, 72, 64
    yy, xx = np.mgrid[:H, :W]
    images = rng.normal(0.0, 0.05, (C, H, W)).astype(np.float32)
    cat = np.asarray([[20.3, 18.7], [50.1, 40.6], [33.0, 30.2]])
    for y, x in cat:
        images += np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 8.0)[None] \
            * rng.uniform(0.5, 2.0, (C, 1, 1))
    psfs = np.stack([np.exp(-((np.mgrid[:21, :21] - 10) ** 2).sum(0)
                            / (2 * s ** 2)) for s in (1.2, 1.4, 1.5, 1.3, 1.6)])
    variance = (0.0025 + 0.01 * np.abs(images)).astype(np.float32)
    return {"images": images, "variance": variance,
            "psfs": (psfs / psfs.sum((1, 2), keepdims=True)).astype(
                np.float32),
            "catalog_yx": cat, "gains": np.full(C, 0.01)}


def test_generate_real_blend_matches_jax():
    """The injected-fake blend on synthetic tiles (the real ones are not in
    the repository and are never fetched), over draws that take the
    star, profile and Spergel branches and every dihedral flip."""
    from scarlet_tpu.testing import blendsets as jsets
    from scarlet_tpu_torch.testing import blendsets as tsets

    tiles = [_tile(0), _tile(1)]
    rng_t, rng_j = np.random.default_rng(21), np.random.default_rng(21)
    for _ in range(6):
        _same_blend(tsets.generate_real_blend(rng_t, tiles),
                    jsets.generate_real_blend(rng_j, tiles))
    t = tiles[0]
    assert_array_equal(tsets._fit_band_gains(t["images"], t["variance"]),
                       jsets._fit_band_gains(t["images"], t["variance"]))


def test_generate_real_blend_set_reads_its_data_dir(tmp_path, monkeypatch):
    """The set-9 writer on two synthetic cutouts in the reference's file
    layout: the JAX package's, pointed at the same directory, writes the
    same blends."""
    from scarlet_tpu.testing import blendsets as jsets

    data = tmp_path / "data"
    data.mkdir()
    dt = [("y", "<f8"), ("x", "<f8")]
    for name, seed in (("hsc_cosmos_35", 2), ("hsc_cosmos", 3)):
        t = _tile(seed)
        cat = np.zeros(len(t["catalog_yx"]), dt)
        cat["y"], cat["x"] = t["catalog_yx"].T
        np.savez(data / f"{name}.npz", images=t["images"],
                 variance=t["variance"], psfs=t["psfs"], catalog=cat)
    monkeypatch.setattr(jsets, "_REF_DATA", data)
    ours = st.testing.generate_real_blend_set(n=2, root=tmp_path / "t",
                                              data_dir=data)
    theirs = jsets.generate_real_blend_set(n=2, root=tmp_path / "j")
    for p, q in zip(ours, theirs):
        with np.load(p) as a, np.load(q) as b:
            _same_blend(dict(a), dict(b))
