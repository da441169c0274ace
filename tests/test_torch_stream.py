"""The port's device stream (``scarlet_tpu_torch.parallel.stream``)
against the JAX package's on the CPU, on the same generated blends
(seeds 0, 1, 2 and 4: blends a 1e-7 perturbation of the images leaves in
place under the fit) packed the way bench.py's ``make_heterogeneous``
packs them, at box 31.

Tolerances: the init's discrete decisions (origins, active slots, slot
sources, box masks, splits, PSF fallbacks, overflow) exactly; the
projection to 1e-6 (bit for bit against the port's own plain passes);
seds and morphs to rtol 1e-4 / atol 1e-4 (the two packages sum the
per-band noise mean in another float32 order, ~1e-5 relative, and the
FFTs differ at roundoff); fit records: iterations
exactly, logL to rtol 1e-4, fluxes, centroids and moments to 1e-4 of
each record's largest value.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu.parallel import batch as jbatch
from scarlet_tpu.parallel import stream as jstream
from scarlet_tpu_torch import convert
from scarlet_tpu_torch.lite import integrated_circular_gaussian
from scarlet_tpu_torch.parallel import batch as tbatch
from scarlet_tpu_torch.parallel import stream as tstream
from scarlet_tpu_torch.testing import generate_blend

SEEDS = (0, 1, 2, 4)
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


def _heterogeneous(seeds):
    blends = [generate_blend(np.random.default_rng(s)) for s in seeds]
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
def het():
    return _heterogeneous(SEEDS)


def _setups(inp, **kw):
    args = (inp["images"], inp["variance"], inp["psfs"], inp["centers"],
            MODEL_PSF)
    kw = dict(center_active=inp["active"], box_size=BOX, **kw)
    return (jstream.stream_setup(*args, platform="cpu", **kw),
            tstream.stream_setup(*args, device="cpu", **kw))


DISCRETE = ("n_active", "overflow", "slot_source", "split", "psf_fallback")


def _assert_setups_match(jout, tout):
    cj, dj, sj, aj = jout
    ct, dt, st, at = tout
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    for k in DISCRETE:
        assert_array_equal(at[k].numpy(), np.asarray(aj[k]))
    for f in ("origins", "comp_active"):
        assert_array_equal(getattr(st, f)[0].numpy(),
                           np.asarray(getattr(sj, f)[0]))
    assert_array_equal(dt.box_masks[0].numpy(), np.asarray(dj.box_masks[0]))
    assert_array_equal(dt.weights.numpy(), np.asarray(dj.weights, np.float32))
    assert_allclose(st.seds[0].numpy(), np.asarray(sj.seds[0]), rtol=1e-4,
                    atol=1e-4)
    assert_allclose(st.morphs[0].numpy(), np.asarray(sj.morphs[0]),
                    rtol=1e-4, atol=1e-4)
    assert_allclose(at["snr"].numpy(), np.asarray(aj["snr"]), rtol=1e-4)
    assert_allclose(dt.bg_rms.numpy(), np.asarray(dj.bg_rms), rtol=1e-4)


def test_stream_setup_matches_jax(het):
    jout, tout = _setups(het, n_slots=12)
    _assert_setups_match(jout, tout)
    assert tout[3]["split"].any() and not tout[3]["overflow"].all()


def test_mono_project_matches_depth_passes(het):
    """The init projection through kernel ``monotonic_prox`` (exact exit)
    equals ``depth`` plain Jacobi passes bit for bit, and the JAX
    package's to 1e-6: XLA on the CPU contracts its multiply-adds into
    fused ones, which round once where the port rounds twice (measured:
    1 ulp, 1.2e-7)."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:BOX, :BOX] - BOX // 2
    x = (np.exp(-(yy ** 2 + xx ** 2) / rng.uniform(4, 40, (2, 3, 1, 1)))
         + 0.2 * rng.normal(size=(2, 3, BOX, BOX))).astype(np.float32)
    w8, keep, depth = tstream._centered_mono_table(BOX)
    got = tstream._mono_project(torch.from_numpy(x), torch.from_numpy(w8),
                                torch.from_numpy(keep), depth).numpy()
    jw, jkeep, jdepth = jstream._centered_mono_table(BOX)
    assert jdepth == depth
    project = jax.vmap(jax.vmap(
        lambda a: jstream._mono_project(a, jnp.asarray(jw),
                                        jnp.asarray(jkeep), jdepth)))
    assert_allclose(got, np.asarray(project(jnp.asarray(x))), rtol=1e-6,
                    atol=1e-6)
    from scarlet_tpu_torch.ops import kernels as kn

    x0 = torch.from_numpy(x)
    w = torch.from_numpy(w8)[[0]]
    keep_b = torch.from_numpy(keep)[0] > 0.5
    ref = x0
    for _ in range(depth):
        ref = kn._mono_pass(ref, x0, w, keep_b, 1.0)
    assert_array_equal(got, ref.numpy())


def test_deblend_stream_matches_jax(het):
    """Chunks of 2, compaction after 20 iterations, and an overflow retry
    (n_slots 11: seed 2's blend wants 12 components)."""
    args = (het["images"], het["variance"], het["psfs"], het["centers"],
            MODEL_PSF)
    kw = dict(center_active=het["active"], box_size=BOX, n_slots=11,
              max_iter=40, check_every=10, chunk=2, compact=20,
              retry_overflow=True)
    rec_j = jstream.deblend_device_stream(*args, **kw)[0]
    rec_t, state, losses, aux = tstream.deblend_device_stream(
        *args, device="cpu", **kw)
    assert len(rec_t) == len(rec_j) == len(SEEDS)
    assert [r.get("overflow_retried", False) for r in rec_t] == \
        [r.get("overflow_retried", False) for r in rec_j]
    assert any(r.get("overflow_retried") for r in rec_t)
    assert isinstance(aux, list) and "retry_indices" in aux[-1]
    for a, b in zip(rec_t, rec_j):
        assert a["iterations"] == b["iterations"]
        assert a["n_components"] == b["n_components"]
        assert a["overflow"] == b["overflow"]
        assert_allclose(a["logL"], b["logL"], rtol=1e-4)
        assert_allclose(a["init logL"], b["init logL"], rtol=1e-4)
        _assert_records_close(a, b)


def _assert_records_close(a, b):
    """Fluxes, centroids and moments to 1e-4 of the record's largest
    value: the moments are differences of raw sums (float32 roundoff of
    the larger terms), and the sums run in another order."""
    for k in ("flux", "centroid", "moments"):
        x, y = np.asarray(a[k]), np.asarray(b[k], np.float32)
        assert_array_equal(np.isnan(x), np.isnan(y))
        scale = np.nanmax(np.abs(y))
        assert np.nanmax(np.abs(x - y)) <= 1e-4 * scale, k


def test_nonfinite_pixels_and_out_of_frame_centers(het):
    """NaN pixels and negative variance are sanitized, an out-of-frame
    catalog row is switched off, in both packages alike; the port's fit
    stays finite."""
    inp = {k: v.copy() for k, v in het.items()}
    inp["images"][0, 1, 10:13, 20:24] = np.nan
    inp["variance"][0, 2, 40, 5] = -1.0
    inp["images"][2, 0, 5, 5] = np.inf
    inp["centers"][1, 0] = (-5, 10)
    jout, tout = _setups(inp, n_slots=12)
    _assert_setups_match(jout, tout)
    config, data, state, aux = tout
    assert not (aux["slot_source"][1] == 0).any()
    assert torch.isfinite(data.images).all()
    assert float(data.weights[0, 1, 11, 21]) == 0.0
    out, losses = tbatch.fit_batch_device_converged(state, data, config, 10,
                                                    check_every=5)
    assert torch.isfinite(losses).all()
    recs = tstream.stream_records(out, losses, aux)
    assert all(np.isfinite(r["logL"]) for r in recs)


def test_stream_records_reweight_matches_jax(het):
    """Records of one fitted JAX state, converted.  Raw fluxes, centroids
    and moments against the JAX package's.  The reweighted fluxes divide
    each source's convolved model by the total one, which far from the
    sources is FFT roundoff (~1e-7 of the peak) of either sign, so two FFT
    implementations part there by ratios of order 1: they are held
    against the JAX renders they divide (to 1e-5 of the peak) and against
    ``weight_sources``' formula on the port's renders."""
    from scarlet_tpu.lite import engine as jeng
    from scarlet_tpu_torch.lite import engine as teng

    cj, dj, sj, aj = jstream.stream_setup(
        het["images"], het["variance"], het["psfs"], het["centers"],
        MODEL_PSF, center_active=het["active"], box_size=BOX, n_slots=12,
        platform="cpu")
    sj, lj = jbatch.fit_batch(sj, dj, cj, 5)
    cfg, d, s = convert.from_jax(dataclasses.asdict(cj), jax.device_get(dj),
                                 jax.device_get(sj), device="cpu")
    aux = {k: torch.from_numpy(np.array(v)) for k, v in aj.items()}
    losses = torch.from_numpy(np.array(lj, np.float32))
    rj = jstream.stream_records(sj, lj, aj)
    rt = tstream.stream_records(s, losses, aux)
    for a, b in zip(rt, rj):
        assert a["iterations"] == b["iterations"]
        assert_allclose(a["init logL"], b["init logL"], rtol=1e-5)
        _assert_records_close(a, b)

    render_j = jax.vmap(lambda st, dt: jeng.render(st, dt, cj),
                        in_axes=(0, jbatch._data_in_axes(dj)))
    total = np.maximum(teng.render(s, d, cfg).numpy(), 0.0)
    imgs = d.images.numpy() * (d.weights.numpy() > 0)
    reweighted = tstream.stream_records(s, losses, aux, data=d, config=cfg,
                                        reweight=True)
    on, src = s.comp_active[0], aux["slot_source"]
    for k in range(aux["snr"].shape[1]):
        sel = on & (src == k)
        conv = teng.render(s._replace(comp_active=(sel,)), d, cfg).numpy()
        ref = np.asarray(render_j(
            sj._replace(comp_active=(jnp.asarray(sel.numpy()),)), dj))
        assert np.abs(conv - ref).max() <= 1e-5 * np.abs(ref).max()
        ratio = np.where(total > 0, np.maximum(conv, 0.0)
                         / np.where(total > 0, total, 1.0), 0.0)
        flux = (np.minimum(ratio, 1.0) * imgs).sum(axis=(-2, -1))
        got = np.stack([r["flux"][k] for r in reweighted])
        assert_allclose(got, flux, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="reweight"):
        tstream.stream_records(s, losses, aux, reweight=True)


def test_dispatch_collect_equals_converged(het):
    config, data, state, _ = tstream.stream_setup(
        het["images"][:2], het["variance"][:2], het["psfs"][:2],
        het["centers"][:2], MODEL_PSF, center_active=het["active"][:2],
        box_size=BOX, n_slots=12, device="cpu")
    handle = tbatch.fit_batch_device_dispatch(state, data, config, 12,
                                              check_every=5)
    out, losses = tbatch.fit_batch_device_collect(handle, 12)
    ref, ref_losses = tbatch.fit_batch_device_converged(state, data, config,
                                                        12, check_every=5)
    assert torch.equal(losses, ref_losses)
    assert torch.equal(out.morphs[0], ref.morphs[0])
    # the caller's state is left as it was
    assert int(state.it.max()) == 0


@pytest.mark.parametrize("option,extra", [
    (dict(box_grow=0.1), dict(max_iter=3, check_every=3)),
    (dict(box_grow=0.1), dict(max_iter=6, check_every=2, chunk=1,
                              compact=2)),
    (dict(mono_tol_early=1e-2, mono_tol_switch=10),
     dict(max_iter=14, check_every=7))],
    ids=["box_grow", "box_grow-compact", "mono_tol_switch"])
def test_stream_fit_options_run_like_jax(het, option, extra):
    """One stream call with a fit option, against the JAX stream with the
    same option: finite logL within rtol 1e-5, the same iterations, the
    growth state carried through compaction as the JAX stream carries
    it, and under the schedule no blend frozen before the switch."""
    args = (het["images"][:2], het["variance"][:2], het["psfs"][:2],
            het["centers"][:2], MODEL_PSF)
    kw = dict(center_active=het["active"][:2], box_size=BOX, n_slots=12,
              e_rel=1e-2, **option, **extra)
    rec_j, state_j = jstream.deblend_device_stream(*args, **kw)[:2]
    rec_t, state_t = tstream.deblend_device_stream(*args, device="cpu",
                                                   **kw)[:2]
    for a, b in zip(rec_t, rec_j):
        assert np.isfinite(a["logL"])
        assert a["iterations"] == b["iterations"]
        assert_allclose(a["logL"], b["logL"], rtol=1e-5)
    if "box_grow" in option:
        assert_array_equal(state_t.box_half[0].numpy(),
                           np.asarray(state_j.box_half[0]))
        assert_array_equal(state_t.step_scale[0].numpy(),
                           np.asarray(state_j.step_scale[0], np.float32))
    else:
        assert all(r["iterations"] > 10 for r in rec_t)
