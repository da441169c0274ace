"""The port's device detection (``scarlet_tpu_torch.ops.wavelet``,
``scarlet_tpu_torch.parallel.detection`` and the stream's ``centers=None``
and ``redetect``) against the JAX package on the CPU.

JAX runs in float32 (the inputs are cast; ``tests/conftest.py`` turns
x64 on).  Tolerances: the starlet transform to float32 roundoff (1e-6 of
the largest coefficient: the same float32 operations, which XLA may fuse
into multiply-adds); labels, support masks, peak masks and catalogs
exactly; the stream's init decisions exactly and its floats as in
``test_torch_stream.py`` (rtol 1e-4); fitted logL to rtol 1e-4.

The support's sigma and the threshold ``|c| > 3 sigma`` are discrete
decisions on float sums, which the two packages take in other orders.
Catalogs and masks are compared on the blends whose JAX result a 1e-7
relative perturbation of the inputs leaves unchanged, and each test
asserts that enough blends are so.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal
from scipy import ndimage

from scarlet_tpu.ops import arrays as jarrays
from scarlet_tpu.ops import wavelet as jwav
from scarlet_tpu.parallel import detection as jdet
from scarlet_tpu.parallel import stream as jstream
from scarlet_tpu_torch.lite import integrated_circular_gaussian
from scarlet_tpu_torch.ops import wavelet as twav
from scarlet_tpu_torch.parallel import detect_peaks_device
from scarlet_tpu_torch.parallel import detection as tdet
from scarlet_tpu_torch.parallel import stream as tstream
from scarlet_tpu_torch.testing import generate_blend

BOX = 31
MODEL_PSF = integrated_circular_gaussian(sigma=0.8)[None].astype(np.float32)
PLUS = [[0, 1, 0], [1, 1, 1], [0, 1, 0]]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads, as in test_torch_stream.py: parallel test
    workers otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stack(blends):
    return dict(images=np.stack([b["images"] for b in blends]).astype(
                    np.float32),
                variance=np.stack([b["variance"] for b in blends]).astype(
                    np.float32),
                psfs=np.stack([b["psfs"] for b in blends]).astype(
                    np.float32))


@pytest.fixture(scope="module")
def blends6():
    rng = np.random.default_rng(3)
    return _stack([generate_blend(rng) for _ in range(6)])


@pytest.fixture(scope="module")
def crowded():
    rng = np.random.default_rng(1007)
    return _stack([generate_blend(rng, n_sources=10, min_sep=3.0)
                   for _ in range(3)])


def _perturbed(x, seed=0):
    """x with every value moved by a relative 1e-7 (normal), float32."""
    rng = np.random.default_rng(seed)
    return (x.astype(np.float64)
            * (1.0 + 1e-7 * rng.standard_normal(x.shape))).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# wavelets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, -1, 2, -4, 8, 40, -40])
def test_shift_axis_matches_jax(k):
    x = np.random.default_rng(0).normal(size=(2, 11, 13)).astype(np.float32)
    for axis in (-2, -1):
        assert_array_equal(twav.shift_axis(_t(x), k, axis).numpy(),
                           np.asarray(jarrays.shift_axis(jnp.asarray(x), k,
                                                         axis)))


def test_bspline_and_starlet_match_jax(blends6):
    img = blends6["images"].sum(axis=1)                    # (6, 58, 48)
    for j in range(3):
        got = twav.bspline_convolve(_t(img), j).numpy()
        ref = np.asarray(jwav.bspline_convolve(jnp.asarray(img), j))
        assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert twav.get_scales((58, 48)) == jwav.get_scales((58, 48)) == 4
    assert twav.get_scales((58, 48), 9) == 4
    got = twav.starlet_transform(_t(img), scales=3).numpy()
    assert got.shape == (6, 4, 58, 48)
    for b in range(len(img)):
        ref = np.asarray(jwav.starlet_transform(jnp.asarray(img[b]),
                                                scales=3))
        assert_allclose(got[b], ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _support_inputs(blends6):
    """Starlet planes of the band sums and of pure noise, with the noise
    levels of each blend: blends that converge at different iterations."""
    rng = np.random.default_rng(4)
    img = blends6["images"].sum(axis=1)
    sig = np.median(np.sqrt(blends6["variance"]), axis=(1, 2, 3))
    img[1] = rng.normal(size=img[1].shape) * sig[1]       # noise only
    img[4] *= 30.0                                         # very bright
    coeffs = np.stack([np.asarray(jwav.starlet_transform(
        jnp.asarray(i.astype(np.float32)), scales=3)) for i in img])
    valid = np.ones(img.shape, np.float32)
    valid[3, :, 40:] = 0.0                                 # padded crop
    return coeffs.astype(np.float32), sig.astype(np.float32), valid


def _jax_support(coeffs, sig, valid, **kw):
    return np.asarray(jax.vmap(lambda c, s, v: jwav.multiresolution_support_jax(
        c, s, valid=v, **kw))(jnp.asarray(coeffs), jnp.asarray(sig),
                              jnp.asarray(valid)))


def test_support_masks_freeze_per_blend(blends6):
    """Blends converge at different iterations; each keeps the sigma of
    its own last iteration while the others run on.  The inputs are such
    that running a blend on to ``max_iter`` changes its mask."""
    coeffs, sig, valid = _support_inputs(blends6)
    ref = _jax_support(coeffs, sig, valid)
    pert = _jax_support(_perturbed(coeffs), sig, valid)
    got = twav.multiresolution_support(_t(coeffs), _t(sig),
                                       valid=_t(valid)).numpy()
    assert got.dtype == np.int32 and got.shape == coeffs.shape
    stable = [b for b in range(len(coeffs))
              if np.array_equal(ref[b], pert[b])]
    assert len(stable) >= 5
    for b in stable:
        assert_array_equal(got[b], ref[b], err_msg=f"blend {b}")
    # running every blend to max_iter (no convergence exit) differs
    forced = _jax_support(coeffs, sig, valid, epsilon=0.0)
    assert any(not np.array_equal(forced[b], ref[b]) for b in stable)
    # the iteration counts differ between blends
    assert len({_support_iterations(c, s, v)
                for c, s, v in zip(coeffs, sig, valid)}) > 1


def _support_iterations(c, sigma, valid, K=3, epsilon=0.1, max_iter=20):
    """Iterations the support loop of one blend runs (the loop of
    wavelet.py:292-311 of the JAX package, in float64)."""
    v = valid > 0
    n = max(v.sum(), 1)
    sig = np.full(len(c), float(sigma))
    for it in range(1, max_iter + 1):
        x = np.where((np.abs(c) <= K * sig[:, None, None]) & v, c, 0.0)
        mean = x.sum(axis=(1, 2)) / n
        nxt = np.sqrt(np.where(v, (x - mean[:, None, None]) ** 2, 0.0).sum(
            axis=(1, 2)) / n)
        cut = nxt > 0
        if np.all(np.abs(nxt[cut] - sig[cut]) / nxt[cut] < epsilon):
            return it
        sig = nxt
    return max_iter


# ---------------------------------------------------------------------------
# labels and peaks
# ---------------------------------------------------------------------------
def test_labels_match_jax_and_scipy():
    rng = np.random.default_rng(7)
    pos = np.stack([rng.random((41, 37)) < d for d in (0.2, 0.45, 0.7)])
    tdet.label_components_device.host_syncs = 0
    lab = tdet.label_components_device(_t(pos)).numpy()
    assert tdet.label_components_device.host_syncs >= 1
    for b in range(3):
        assert_array_equal(lab[b], np.asarray(
            jdet.label_components_device(pos[b])))
        ref, n = ndimage.label(pos[b], structure=PLUS)
        pairs = set(zip(lab[b][pos[b]].tolist(), ref[pos[b]].tolist()))
        assert len(pairs) == len({p[0] for p in pairs}) \
            == len({p[1] for p in pairs}) == n
        assert (lab[b][~pos[b]] == pos[b].size).all()


def _serpentine():
    """The 12 x 12 mask of tests/test_detect_device.py:53-69."""
    pos = np.zeros((12, 12), bool)
    for r in range(12):
        pos[r, :] = True
        if r % 2 == 0:
            pos[r, :11] = r % 4 == 0
            pos[r, 11 if r % 4 == 0 else 0] = True
    pos[1::2, :] = False
    pos[1::2, 0] = True
    pos[1::2, 11] = True
    return pos


def _snake():
    """One 12 x 12 snake: full even rows joined at alternate ends; its
    labels settle only after 12 changing sweeps."""
    pos = np.zeros((12, 12), bool)
    pos[0::2, :] = True
    pos[1::4, 11] = True
    pos[3::4, 0] = True
    return pos


@pytest.mark.parametrize("shape, syncs", [("serpentine", 1), ("snake", 4)])
def test_serpentine_labels_settle(shape, syncs):
    """The loop reads ``any(changed)`` once per LABEL_SWEEPS sweeps and
    ends at the fixed point, as JAX's loop does.  The snake takes several
    blocks, and a fixed count of LABEL_SWEEPS sweeps has not settled it."""
    pos = _serpentine() if shape == "serpentine" else _snake()
    tdet.label_components_device.host_syncs = 0
    lab = tdet.label_components_device(_t(pos)).numpy()
    assert tdet.label_components_device.host_syncs == syncs
    assert_array_equal(lab, np.asarray(jdet.label_components_device(pos)))
    _, count = ndimage.label(pos, structure=PLUS)
    assert len(np.unique(lab[pos])) == count
    fixed = torch.where(_t(pos), torch.arange(144).reshape(12, 12), 144)
    for _ in range(tdet.LABEL_SWEEPS):
        fixed = tdet._label_pass(fixed[None], _t(pos)[None], 144)[0]
    assert np.array_equal(fixed.numpy(), lab) == (shape == "serpentine")


def test_peak_mask_from_plane_matches_jax():
    """The planes of tests/test_detect_device.py:144-154, as one batch."""
    rng = np.random.default_rng(23)
    planes = []
    for _ in range(6):
        plane = rng.standard_normal((37, 43))
        plane[plane < 0.6] = 0.0
        planes.append(plane)
    planes = np.stack(planes)
    got = tdet.peak_mask_from_plane(_t(planes)).numpy()
    for b in range(6):
        assert_array_equal(got[b], np.asarray(
            jdet.peak_mask_from_plane(planes[b])))
    assert got.any()


def _jax_detect(images, variance, valid=None, **kw):
    return tuple(np.asarray(o) for o in jdet.detect_peaks_device(
        images, variance, valid, **kw))


def _assert_detect_matches(images, variance, valid=None, min_stable=None,
                           **kw):
    """The port's catalogs equal JAX's, row by row, on the blends whose
    JAX catalog a 1e-7 perturbation of the images leaves unchanged."""
    ref = _jax_detect(images, variance, valid, **kw)
    pert = _jax_detect(_perturbed(images), variance, valid, **kw)
    got = [o.numpy() for o in detect_peaks_device(
        _t(images), _t(variance), _t(valid), **kw)]
    stable = [b for b in range(len(images))
              if all(np.array_equal(r[b], p[b]) for r, p in zip(ref, pert))]
    assert len(stable) >= (len(images) if min_stable is None
                           else min_stable)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert_array_equal(g[stable], r[stable])
    return got


def test_detect_peaks_matches_jax(blends6):
    """6 generated blends (tests/test_detect_device.py:83-97): the rows in
    brightest-first order, ``active`` and ``n_found``."""
    c, a, n = _assert_detect_matches(blends6["images"], blends6["variance"],
                                     min_stable=5, max_peaks=48)
    assert (n == a.sum(axis=1)).all() and (n >= 3).all()
    # inactive rows come out in ascending flat index, as lax.top_k's
    for b in range(len(c)):
        flat = c[b][~a[b]][:, 0] * 48 + c[b][~a[b]][:, 1]
        assert (np.diff(flat) > 0).all()


def test_detect_peaks_cut_to_max_peaks(blends6):
    """max_peaks below the peak count keeps the brightest rows and reports
    the uncut count."""
    images, variance = blends6["images"], blends6["variance"]
    full = _assert_detect_matches(images, variance, min_stable=5,
                                  max_peaks=48)
    cut = _assert_detect_matches(images, variance, min_stable=5,
                                 max_peaks=3)
    assert (full[2] > 3).any()
    assert_array_equal(cut[2], full[2])
    assert_array_equal(cut[0], full[0][:, :3])
    assert_array_equal(cut[1], full[2][:, None] > np.arange(3))


def test_detect_peaks_min_separation_matches_jax():
    rng = np.random.default_rng(19)
    inp = _stack([generate_blend(rng) for _ in range(3)])
    for sep in (2.0, 5.0):
        _assert_detect_matches(inp["images"], inp["variance"], min_stable=2,
                               max_peaks=12, min_separation=sep)


def test_blank_scene_finds_nothing():
    images = np.zeros((2, 3, 40, 36), np.float32)
    variance = np.full_like(images, 1e-4)
    c, a, n = (o.numpy() for o in detect_peaks_device(
        _t(images), _t(variance), max_peaks=8))
    assert not a.any() and (n == 0).all()
    ref = _jax_detect(images, variance, max_peaks=8)
    for g, r in zip((c, a, n), ref):
        assert_array_equal(g, r)


def test_scene_valid_padding_is_silent():
    """Zero-padded crops: the padding finds nothing, and the catalog is
    the natural crop's (tests/test_detect_device.py:190-211)."""
    b = generate_blend(np.random.default_rng(5))
    C, H, W = b["images"].shape
    pim = np.zeros((2, C, H + 14, W + 10), np.float32)
    pva = np.zeros_like(pim)
    valid = np.zeros((2, H + 14, W + 10), np.float32)
    pim[0, :, :H, :W] = b["images"]
    pva[0, :, :H, :W] = b["variance"]
    valid[0, :H, :W] = 1.0
    pim[1, :, 7:7 + H, 3:3 + W] = b["images"]
    pva[1, :, 7:7 + H, 3:3 + W] = b["variance"]
    valid[1, 7:7 + H, 3:3 + W] = 1.0
    c, a, _ = _assert_detect_matches(pim, pva, valid, max_peaks=32)
    nat = [o.numpy() for o in detect_peaks_device(
        _t(b["images"][None].astype(np.float32)),
        _t(b["variance"][None].astype(np.float32)), max_peaks=32)]
    natural = {tuple(p) for p in nat[0][0][nat[1][0]]}
    assert {tuple(p) for p in c[0][a[0]]} == natural
    assert {tuple(p - (7, 3)) for p in c[1][a[1]]} == natural


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------
DISCRETE = ("n_active", "overflow", "slot_source", "split", "psf_fallback",
            "detected_peaks", "centers", "center_active")


def test_stream_setup_detects_like_jax():
    inp = _stack([generate_blend(np.random.default_rng(s))
                  for s in (0, 1, 2)])
    args = (inp["images"], inp["variance"], inp["psfs"], None, MODEL_PSF)
    kw = dict(box_size=BOX, n_slots=12, max_peaks=10)
    _, dj, sj, aj = jstream.stream_setup(*args, platform="cpu", **kw)
    _, dt, st, at = tstream.stream_setup(*args, device="cpu", **kw)
    # the catalogs stand under a 1e-7 perturbation of the images
    pert = jstream.stream_setup(_perturbed(inp["images"]), *args[1:],
                                platform="cpu", **kw)[3]
    for k in ("centers", "center_active"):
        assert_array_equal(np.asarray(pert[k]), np.asarray(aj[k]))
    for k in DISCRETE:
        assert_array_equal(at[k].numpy(), np.asarray(aj[k]), err_msg=k)
    assert at["center_active"].any(dim=1).all()
    for f in ("origins", "comp_active"):
        assert_array_equal(getattr(st, f)[0].numpy(),
                           np.asarray(getattr(sj, f)[0]))
    assert_array_equal(dt.box_masks[0].numpy(), np.asarray(dj.box_masks[0]))
    assert_allclose(st.seds[0].numpy(), np.asarray(sj.seds[0]), rtol=1e-4,
                    atol=1e-4)
    assert_allclose(st.morphs[0].numpy(), np.asarray(sj.morphs[0]),
                    rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="center_active"):
        tstream.stream_setup(*args, center_active=np.ones((3, 4), bool),
                             device="cpu", **kw)


def test_union_catalogs_matches_jax():
    rng = np.random.default_rng(9)
    centers = rng.integers(0, 30, (4, 6, 2)).astype(np.int32)
    active = rng.random((4, 6)) < 0.6
    det_c = rng.integers(0, 30, (4, 8, 2)).astype(np.int32)
    det_a = rng.random((4, 8)) < 0.7
    det_c[0, 0] = centers[0, 0] + 1            # within the radius
    for cap in (6, 9, 14):
        for a in (active, None):
            got = tstream._union_catalogs(_t(centers), a, det_c, det_a,
                                          3.0, cap)
            ref = jstream._union_catalogs(centers, a, det_c, det_a, 3.0,
                                          cap)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype
                assert_array_equal(g, r)


def _records_match(rec_t, rec_j, blends):
    for b in blends:
        a, r = rec_t[b], rec_j[b]
        assert a["iterations"] == r["iterations"]
        assert a.get("overflow_retried", False) == \
            r.get("overflow_retried", False)
        assert_allclose(a["logL"], r["logL"], rtol=1e-4)


def _catalogs(aux):
    auxs = [a for a in (aux if isinstance(aux, list) else [aux])
            if "retry_indices" not in a]
    return (np.concatenate([np.asarray(a["centers"]) for a in auxs]),
            np.concatenate([np.asarray(a["center_active"]) for a in auxs]))


REDETECT = dict(box_size=BOX, n_slots=24, max_peaks=12, max_iter=20,
                check_every=10, redetect=1)


def test_redetect_matches_jax(crowded):
    """redetect=1 on 3 crowded blends: the grown catalog equals JAX's and
    logL agrees to rtol 1e-4, on the blends whose JAX result a 1e-7
    perturbation of the images leaves in place."""
    args = (crowded["psfs"], None, MODEL_PSF)
    rec_j, _, _, aux_j = jstream.deblend_device_stream(
        crowded["images"], crowded["variance"], *args, **REDETECT)
    rec_p, _, _, aux_p = jstream.deblend_device_stream(
        _perturbed(crowded["images"]), crowded["variance"], *args,
        **REDETECT)
    rec_t, _, _, aux_t = tstream.deblend_device_stream(
        crowded["images"], crowded["variance"], *args, device="cpu",
        **REDETECT)
    cj, aj = _catalogs(aux_j)
    cp, ap = _catalogs(aux_p)
    ct, at = _catalogs(aux_t)
    stable = [b for b in range(3)
              if np.array_equal(cj[b], cp[b]) and np.array_equal(aj[b], ap[b])
              and rec_j[b]["iterations"] == rec_p[b]["iterations"]
              and abs(rec_j[b]["logL"] - rec_p[b]["logL"])
              <= 1e-5 * abs(rec_j[b]["logL"])]
    assert len(stable) >= 2
    assert_array_equal(ct[stable], cj[stable])
    assert_array_equal(at[stable], aj[stable])
    _records_match(rec_t, rec_j, stable)


def test_redetect_chunked_and_compacted(crowded):
    """The residual pass renders each chunk's state: a per-chunk list
    (chunks), or slices of the merged state (chunks and compaction).
    Both give the unchunked run's catalogs and records, and the residuals
    add sources to the first pass's catalog."""
    args = (crowded["images"], crowded["variance"], crowded["psfs"], None,
            MODEL_PSF)
    rec, _, _, aux = tstream.deblend_device_stream(*args, device="cpu",
                                                   **REDETECT)
    cat = _catalogs(aux)
    for kw in (dict(chunk=2), dict(chunk=2, compact=10)):
        rec_c, _, _, aux_c = tstream.deblend_device_stream(
            *args, device="cpu", **REDETECT, **kw)
        assert isinstance(aux_c, list) == ("compact" not in kw)
        for a, b in zip(_catalogs(aux_c), cat):
            assert_array_equal(a, b)
        for a, b in zip(rec_c, rec):
            assert a["iterations"] == b["iterations"]
            assert_allclose(a["logL"], b["logL"], rtol=1e-6)
    _, _, _, aux0 = tstream.deblend_device_stream(
        *args, device="cpu", **dict(REDETECT, redetect=0))
    n0, n1 = _catalogs(aux0)[1].sum(1), cat[1].sum(1)
    assert (n0 <= n1).all() and n0.sum() < n1.sum()


def test_retry_overflow_with_detected_catalog(crowded):
    """centers=None at 6 slots: blends whose detected catalog wants more
    components are refit at a larger slot count, from the detected
    catalog, in both packages alike."""
    args = (crowded["images"], crowded["variance"], crowded["psfs"], None,
            MODEL_PSF)
    kw = dict(box_size=BOX, n_slots=6, max_peaks=12, max_iter=20,
              check_every=10, retry_overflow=True)
    rec_j, _, _, aux_j = jstream.deblend_device_stream(*args, **kw)
    rec_t, _, _, aux_t = tstream.deblend_device_stream(*args, device="cpu",
                                                       **kw)
    assert isinstance(aux_t, list) and "retry_indices" in aux_t[-1]
    ri = aux_t[-1]["retry_indices"]
    assert ri.size and (ri == aux_j[-1]["retry_indices"]).all()
    assert aux_t[-1]["retry_n_slots"] == aux_j[-1]["retry_n_slots"] > 6
    for k in ("centers", "center_active"):
        assert_array_equal(aux_t[-1][k], np.asarray(aux_j[-1][k]))
        assert_array_equal(np.asarray(aux_t[-1][k])[:ri.size],
                           aux_t[0][k].numpy()[ri])
    _records_match(rec_t, rec_j, range(3))
