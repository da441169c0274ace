"""The upload options of the port's device stream
(``scarlet_tpu_torch.parallel.stream.deblend_device_stream``): quantized
uploads (``upload_dtype``) and the upload modes ("bulk", "overlap" and
the bandwidth probe's "auto"), against the JAX package's stream on the
CPU.

Tolerances: the quantized stacks bit for bit against the JAX package's
``astype`` (ml_dtypes, round to nearest even); the bf16-upload stream
against JAX's bf16-upload stream on the same generated blends (seeds 0
and 1): iterations and component counts exactly, logL rtol 1e-5 or 3x
the port's own move on 1e-7 changes of its quantized images, where the
quantized blend is ill-conditioned under the fit (seed 1's), and
against the port's own float32-upload stream within the JAX test's bounds
(tests/test_stream.py:471-502: logL rtol 3e-3, fluxes rtol 0.03 and 2% of
the largest flux); the blends whose init decisions the quantization
flips are counted, not hidden.  The upload modes are routes to the same
programs: bit for bit against each other (tests/test_stream.py:785-805)
and logL rtol 1e-5 against JAX.
"""
import logging

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu import lite as jlite
from scarlet_tpu.parallel import stream as jstream
from scarlet_tpu_torch.lite import integrated_circular_gaussian
from scarlet_tpu_torch.parallel import stream as tstream
from scarlet_tpu_torch.testing import generate_blend

BOX = 31
MODEL_PSF = integrated_circular_gaussian(sigma=0.8)[None].astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    """Generated blends of seeds 0 and 1 packed as bench.py packs them."""
    blends = [generate_blend(np.random.default_rng(s)) for s in (0, 1)]
    K = max(len(b["catalog"]) for b in blends)
    centers = np.zeros((len(blends), K, 2), np.int32)
    active = np.zeros((len(blends), K), bool)
    for i, b in enumerate(blends):
        k = len(b["catalog"])
        centers[i, :k, 0] = np.round(b["catalog"]["y"])
        centers[i, :k, 1] = np.round(b["catalog"]["x"])
        active[i, :k] = True
    return dict(images=np.stack([b["images"] for b in blends]),
                variance=np.stack([b["variance"] for b in blends]),
                psfs=np.stack([b["psfs"] for b in blends]),
                centers=centers, active=active)


@pytest.fixture(scope="module")
def small():
    """The JAX package's upload-mode batch (tests/test_stream.py:790-800):
    8 single-source blends, 3 bands, 32 x 32, box 15."""
    rng = np.random.RandomState(0)
    B, C, H, W = 8, 3, 32, 32
    psf = jlite.integrated_circular_gaussian(sigma=1.2).astype(np.float32)
    psfs = np.repeat(np.repeat(psf[None], C, 0)[None], B, 0)
    variance = np.full((B, C, H, W), 1e-2, np.float32)
    images = rng.randn(B, C, H, W).astype(np.float32) * 0.05
    ph = psf.shape[0] // 2
    images[:, :, 16 - ph:16 + ph + 1, 16 - ph:16 + ph + 1] += psf * 3.0
    centers = np.tile(np.asarray([[16, 16]], np.int32), (B, 1, 1))
    mp = jlite.integrated_circular_gaussian(
        sigma=0.6)[None].astype(np.float32)
    return (images, variance, psfs, centers, mp)


SMALL_KW = dict(box_size=15, n_slots=2, max_iter=6, check_every=3, chunk=3)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16)


@pytest.mark.parametrize("name,jdtype", [("bfloat16", jnp.bfloat16),
                                         ("float16", jnp.float16)])
def test_quantized_stacks_equal_jax_astype(name, jdtype):
    """The host quantization (``_host_stack``, what ``_upload`` copies)
    bit for bit against ``x.astype(jnp.bfloat16)`` (and float16): values
    at rounding ties, subnormals, infinities, values past float16's
    range, signed zeros; integer and bool stacks pass unquantized."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 3, 17, 19))
         * 10.0 ** rng.integers(-8, 8, size=(4, 3, 17, 19))).astype(
             np.float32)
    flat = x.reshape(-1)
    # exact ties between two bf16 values, either parity; float32
    # subnormals; past float16's largest value; signed zeros and inf
    flat[:6] = np.array([0x3F808000, 0x3F818000, 0x00000001, 0x00700000,
                         0x80000000, 0x7F800000], np.uint32).view(np.float32)
    flat[6:9] = [70000.0, -1e-30, 65520.0]
    qdtype = tstream._quant_dtype(name)
    assert qdtype is getattr(torch, name)
    assert tstream._quant_dtype(qdtype) is qdtype
    got = tstream._host_stack(x, qdtype)
    with np.errstate(over="ignore"):
        ref = x.astype(jdtype)
    assert got.dtype == qdtype and got.shape == x.shape
    assert_array_equal(_bits(got.view(torch.int16).numpy()), _bits(ref))
    up = tstream._upload(x, torch.device("cpu"), qdtype)
    assert torch.equal(up.view(torch.int16), got.view(torch.int16))
    mask = np.ones((4, 17, 19), bool)
    assert tstream._host_stack(mask, qdtype).dtype == torch.bool
    assert tstream._host_stack(x, None).dtype == torch.float32


def test_upload_dtype_names():
    for bad in ("float32", torch.float32, "int8", np.float16):
        with pytest.raises(ValueError, match="upload_dtype"):
            tstream._quant_dtype(bad)
    with pytest.raises(ValueError, match="upload mode"):
        tstream.deblend_device_stream(
            np.zeros((2, 1, 16, 16), np.float32),
            np.ones((2, 1, 16, 16), np.float32),
            np.ones((2, 1, 5, 5), np.float32) / 25.0,
            np.zeros((2, 1, 2), np.int32),
            np.ones((1, 5, 5), np.float32) / 25.0,
            box_size=15, n_slots=1, upload="stream", device="cpu")


def _decisions(aux):
    auxs = aux if isinstance(aux, list) else [aux]
    return {k: np.concatenate([np.asarray(a[k]) for a in auxs])
            for k in ("n_active", "split", "psf_fallback", "slot_source")}


GEN_KW = dict(box_size=BOX, n_slots=12, max_iter=15, check_every=15)


@pytest.fixture(scope="module")
def bf16_streams(gen):
    args = (gen["images"], gen["variance"], gen["psfs"], gen["centers"],
            MODEL_PSF)
    kw = dict(center_active=gen["active"], **GEN_KW)
    rec_j = jstream.deblend_device_stream(*args, upload_dtype=jnp.bfloat16,
                                          **kw)[0]
    out16 = tstream.deblend_device_stream(*args, upload_dtype="bfloat16",
                                          device="cpu", **kw)
    out32 = tstream.deblend_device_stream(*args, device="cpu", **kw)
    return rec_j, out16, out32


def _own_move(gen, rec, copies=3):
    """The largest relative logL move of the port's bf16-upload stream on
    copies of its quantized stacks times (1 + 1e-7 N(0, 1)) (tensor
    inputs: the quantized values, perturbed, reach the fit as they are)."""
    q = [torch.from_numpy(gen[k]).to(torch.bfloat16).to(torch.float32)
         for k in ("images", "variance", "psfs")]
    rng = np.random.default_rng(0)
    move = np.zeros(len(rec))
    for _ in range(copies):
        noise = 1e-7 * rng.standard_normal(gen["images"].shape)
        ims = q[0] * torch.from_numpy((1 + noise).astype(np.float32))
        out = tstream.deblend_device_stream(
            ims, q[1], q[2], gen["centers"], MODEL_PSF,
            center_active=gen["active"], device="cpu", **GEN_KW)[0]
        move = np.maximum(move, [abs(a["logL"] - b["logL"]) / abs(b["logL"])
                                 for a, b in zip(out, rec)])
    return move


def test_bf16_stream_matches_jax(gen, bf16_streams):
    """logL rtol 1e-5, or 3x the port's own move on perturbed copies where
    the quantized blend is ill-conditioned under the fit: quantized, seed
    1's blend parts from itself by 1.2e-5 on 1e-7 changes of its images
    (in the JAX package too), and from JAX by 1.3e-5; seed 0's stays
    within 1.4e-7."""
    rec_j, (rec_t, state, _, aux), _ = bf16_streams
    assert state.morphs[0].dtype == torch.float32
    limit = np.maximum(1e-5, 3.0 * _own_move(gen, rec_t))
    assert limit[0] == 1e-5
    for a, b, lim in zip(rec_t, rec_j, limit):
        assert a["iterations"] == b["iterations"]
        assert a["n_components"] == b["n_components"]
        assert np.isfinite(a["logL"])
        assert_allclose(a["logL"], b["logL"], rtol=lim)
        assert_allclose(a["init logL"], b["init logL"], rtol=1e-5)


def test_bf16_stream_within_the_jax_bound_of_float32(bf16_streams):
    """The JAX test's own bound of the bf16 upload against the float32
    upload; the blends whose init decisions moved are counted (on these
    two blends, none)."""
    _, (r16, _, _, aux16), (r32, _, _, aux32) = bf16_streams
    d16, d32 = _decisions(aux16), _decisions(aux32)
    flipped = sorted({int(b) for k in d16
                      for b in np.nonzero((d16[k] != d32[k]).reshape(
                          len(r16), -1).any(axis=1))[0]})
    assert flipped == []
    for a, b in zip(r32, r16):
        assert_allclose(a["logL"], b["logL"], rtol=3e-3)
        total = np.abs(a["flux"]).max()
        assert_allclose(b["flux"], a["flux"], rtol=0.03, atol=0.02 * total)
    # and the quantization did reach the fit
    assert any(a["logL"] != b["logL"] for a, b in zip(r32, r16))


def test_tensor_inputs_are_not_quantized(small):
    """Device-resident (tensor) stacks are left as they are: the same
    records with and without ``upload_dtype``."""
    images, variance, psfs, centers, mp = small
    t = [torch.from_numpy(x) for x in (images, variance, psfs)]
    a = tstream.deblend_device_stream(*t, centers, mp, device="cpu",
                                      **SMALL_KW)[0]
    b = tstream.deblend_device_stream(*t, centers, mp, device="cpu",
                                      upload_dtype=torch.bfloat16,
                                      **SMALL_KW)[0]
    assert [r["logL"] for r in a] == [r["logL"] for r in b]


@pytest.fixture(scope="module")
def modes(small):
    """Each upload mode, with and without bf16 uploads, on the port and
    (bulk) on the JAX package."""
    images, variance, psfs, centers, mp = small
    out = {}
    for q in (None, "bfloat16"):
        for mode in ("bulk", "overlap", "auto"):
            rec = tstream.deblend_device_stream(
                images, variance, psfs, centers, mp, upload=mode,
                upload_dtype=q, device="cpu", **SMALL_KW)[0]
            out[q, mode] = np.asarray([r["logL"] for r in rec])
        rec = jstream.deblend_device_stream(
            images, variance, psfs, centers, mp, upload="bulk",
            upload_dtype=q, **SMALL_KW)[0]
        out[q, "jax"] = np.asarray([r["logL"] for r in rec])
    return out


@pytest.mark.parametrize("q", [None, "bfloat16"])
def test_upload_modes_bitwise(modes, q):
    assert np.isfinite(modes[q, "bulk"]).all()
    assert np.array_equal(modes[q, "bulk"], modes[q, "overlap"])
    assert np.array_equal(modes[q, "bulk"], modes[q, "auto"])
    assert_allclose(modes[q, "bulk"], modes[q, "jax"], rtol=1e-5)


def test_auto_picks_by_the_probe(small, monkeypatch, caplog):
    """"auto" probes once per host call of more than one chunk, and not
    for tensor inputs or one chunk; the choice is logged as in JAX."""
    images, variance, psfs, centers, mp = small
    probes = []

    def probe(device, nbytes=4 << 20):
        probes.append(device)
        return 1.0

    monkeypatch.setattr(tstream, "_upload_bandwidth_mbs", probe)
    caplog.set_level(logging.INFO, logger="scarlet_tpu_torch.parallel.stream")
    rec = tstream.deblend_device_stream(
        images, variance, psfs, centers, mp, upload="auto",
        upload_bw_mbs=100.0, device="cpu", **SMALL_KW)[0]
    assert probes == [torch.device("cpu")]
    assert "1.0 MB/s idle upload -> overlap uploads" in caplog.text
    assert len(rec) == len(images)
    one = dict(SMALL_KW, chunk=None)
    tstream.deblend_device_stream(images, variance, psfs, centers, mp,
                                  upload="auto", device="cpu", **one)
    tstream.deblend_device_stream(
        *(torch.from_numpy(x) for x in (images, variance, psfs)), centers,
        mp, upload="auto", device="cpu", **SMALL_KW)
    assert len(probes) == 1


def test_bandwidth_probe_warms_full_size(monkeypatch):
    """The probe's warm-up transfer is the timed one's size, in the port
    (two transfers of the bulk path's kind, ``_upload``) as in the JAX
    package (two ``device_put``, tests/test_stream.py:807-838)."""
    sizes, jsizes = [], []
    real, jreal = tstream._upload, jax.device_put

    def spy(x, device, qdtype=None):
        sizes.append(np.asarray(x).nbytes)
        return real(x, device, qdtype)

    def jspy(x, *a, **k):
        jsizes.append(np.asarray(x).nbytes)
        return jreal(x, *a, **k)

    monkeypatch.setattr(tstream, "_upload", spy)
    monkeypatch.setattr(jstream.jax, "device_put", jspy)
    assert tstream._upload_bandwidth_mbs(torch.device("cpu")) > 0
    assert jstream._upload_bandwidth_mbs() > 0
    assert sizes == jsizes == [4 << 20] * 2


def test_redetect_with_upload_dtype_matches_jax(small):
    """``redetect=1`` with bf16 uploads: the JAX package sanitizes the host
    stacks in numpy, fits each pass on them quantized and detects on the
    float32 residuals.  Records and the grown catalogs against JAX."""
    images, variance, psfs, centers, mp = small
    images = images.copy()
    images[0, 0, 3, 4] = np.nan            # sanitized on the host first
    kw = dict(SMALL_KW, redetect=1, upload_dtype="bfloat16")
    rec_j, _, _, aux_j = jstream.deblend_device_stream(
        images, variance, psfs, centers, mp, **kw)
    rec_t, _, _, aux_t = tstream.deblend_device_stream(
        images, variance, psfs, centers, mp, device="cpu", **kw)
    for a, b in zip(rec_t, rec_j):
        assert a["iterations"] == b["iterations"]
        assert a["n_components"] == b["n_components"]
        assert np.isfinite(a["logL"])
        assert_allclose(a["logL"], b["logL"], rtol=1e-5)
    for a, b in zip(aux_t, aux_j):
        assert_array_equal(a["centers"], np.asarray(b["centers"]))
        assert_array_equal(a["center_active"],
                           np.asarray(b["center_active"]))


@pytest.mark.parametrize("redetect", [0, 1])
def test_overflow_retry_reads_unquantized_stacks(small, redetect):
    """With bf16 uploads the overflow retry refits from the unquantized
    host stacks, as the JAX stream does where it runs (the per-chunk
    "overlap" uploads).  Where the JAX stream bound its host stacks to the
    quantized device copies (bulk uploads, and every ``redetect`` pass)
    its retry hands bf16 to ``stream_setup`` and raises (a reference
    fault, ROADMAP Queue 3); the port runs.  Every blend is retried here
    (n_slots 1, two catalog rows), so every record comes from the
    retry: against JAX's overlap stream, and with ``redetect`` against
    JAX's float32 redetect stream (the same final catalogs)."""
    images, variance, psfs, centers, mp = small
    centers = np.concatenate(
        [centers, np.tile(np.asarray([[[8, 24]]], np.int32),
                          (len(centers), 1, 1))], axis=1)
    args = (images, variance, psfs, centers, mp)
    kw = dict(SMALL_KW, n_slots=1, retry_overflow=True, redetect=redetect)
    with pytest.raises(ValueError, match="bfloat16"):
        jstream.deblend_device_stream(*args, upload_dtype="bfloat16",
                                      upload="bulk", **kw)
    if redetect:
        rec_j, _, _, aux_j = jstream.deblend_device_stream(*args, **kw)
    else:
        rec_j, _, _, aux_j = jstream.deblend_device_stream(
            *args, upload_dtype="bfloat16", upload="overlap", **kw)
    rec_t, _, _, aux_t = tstream.deblend_device_stream(
        *args, upload_dtype="bfloat16", device="cpu", **kw)
    assert all(r.get("overflow_retried") for r in rec_t)
    assert all(r.get("overflow_retried") for r in rec_j)
    for a, b in zip(rec_t, rec_j):
        assert a["iterations"] == b["iterations"]
        assert a["n_components"] == b["n_components"]
        assert_allclose(a["logL"], b["logL"], rtol=1e-5)
    if redetect:
        assert_array_equal(aux_t[-1]["centers"],
                           np.asarray(aux_j[-1]["centers"]))
