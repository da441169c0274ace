"""The port's batched multi-resolution fitter (``parallel.multires``)
against the JAX package's on the CPU.

Inputs: the synthetic HR + LR pair of tests/test_multiresolution.py at
small widths (HR 32 x 32, LR 12 x 12), aligned or rotated by 28 degrees,
as both packages build it (``make_pair``), in batches whose blends differ
by a flux scale (tests/test_multires_batch.py), weights 400.  The scenes
are well conditioned: a 1e-7 relative change of the images moves the
15-iteration losses by less than 1e-6 relative (``test_well_conditioned``).

Tolerances: the scene and its gradient 1e-6 of their largest value; the
loss and its gradient 1e-4 relative (float32 renders summed in another
order); fits: losses rtol 1e-4, seds and morphs within 1e-4 of their
largest value, iterations and grown box sizes equal; records rtol 1e-6
on the same arrays.  ``multires_init`` is bit for bit where the model PSF
is an observation's own image and that image's float32 sum is exact
(dyadic PSFs, as in tests/test_torch_resolution.py): the normalization
sum is the one place where XLA's and torch's summation orders differ.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp
import scarlet_tpu as st
from scarlet_tpu.parallel import multires as jmr
from scarlet_tpu_torch import convert
from scarlet_tpu_torch import models as tm
from scarlet_tpu_torch.parallel import multires as tmr
from scarlet_tpu_torch.testing import blob_centers, make_pair
from test_multiresolution import make_pair as jax_make_pair
from test_torch_resolution import ROT, _frames

SMALL = dict(shape_hr=(32, 32), shape_lr=(12, 12))
SCALES = (1.0, 0.7, 1.5)


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _setup(rotation, scales=SCALES, widths=SMALL):
    """Both packages' observations (hr, lr) of make_pair with their model
    frames, and the batch stacks (numpy)."""
    jh, jl, dh, dl = jax_make_pair(rotation_lr=rotation, **widths)
    th, tl, dh2, dl2 = make_pair(rotation_lr=rotation, device="cpu",
                                 **widths)
    assert_array_equal(dh, dh2)
    assert_array_equal(dl, dl2)
    jf = st.Frame.from_observations([jl, jh], obs_id=1)
    tf = tm.Frame.from_observations([tl, th], obs_id=1)
    scales = np.asarray(scales, np.float32)
    datas = (np.stack([dh[None] * s for s in scales]),
             np.stack([dl[None] * s for s in scales]))
    weights = tuple(np.full_like(d, 400.0) for d in datas)
    return (jh, jl), (th, tl), tf, datas, weights


@pytest.fixture(scope="module")
def aligned():
    return _setup(0.0)


@pytest.fixture(scope="module")
def rotated():
    return _setup(ROT, scales=(1.0, 1.3))


def _init(setup, box=15, inactive=True):
    """Both packages' init (the port's arrays) with the third slot of
    blend 1 switched off."""
    jobs, tobs, tf, datas, _ = setup
    centers = blob_centers(tf, datas[0].shape[0])
    if inactive:
        centers[1, 2] = np.nan
    ji = jmr.multires_init(jobs, datas, centers, box_size=box, n_slots=3)
    ti = tmr.multires_init(tobs, datas, centers, box_size=box, n_slots=3)
    for a, b in zip(ji, ti):
        assert_allclose(b, np.asarray(a), rtol=1e-6, atol=0)
    return ti


def _fits(setup, n_iter=15, box=15, inactive=True, **kw):
    jobs, tobs, _, datas, weights = setup
    init = _init(setup, box, inactive)
    jfit = jmr.MultiResFitter(jobs, box_size=box, **kw)
    tfit = tmr.MultiResFitter(tobs, box_size=box, **kw)
    jout = jfit.fit(datas, weights, *init, n_iter=n_iter)
    tout = tfit.fit(datas, weights, *init, n_iter=n_iter)
    return (jfit, jout), (tfit, tout), init


def _assert_fits_agree(jout, tout):
    seds, morphs, loss, iters, losses = (np.asarray(a) for a in jout)
    assert_allclose(_np(tout[4]), losses, rtol=1e-4)
    assert_allclose(_np(tout[2]), loss, rtol=1e-4)
    _close(tout[0], seds, 1e-4)
    _close(tout[1], morphs, 1e-4)
    assert_array_equal(_np(tout[3]), iters)


# ---------------------------------------------------------------------------
# The scene Function: K3 forward, K4 backward
# ---------------------------------------------------------------------------
def _scene_inputs(seed=0, B=3, K=3, C=2, S=15, H=40, W=44):
    rng = np.random.default_rng(seed)
    seds = rng.random((B, K, C)).astype(np.float32)
    morphs = rng.random((B, K, S, S)).astype(np.float32)
    origins = np.stack([rng.integers(0, H - S + 1, (B, K)),
                        rng.integers(0, W - S + 1, (B, K))], -1).astype(
                            np.int32)
    origins[0, 1] = origins[0, 0]            # two boxes on one spot
    active = np.ones((B, K), bool)
    active[1, 2] = False
    return seds, morphs, origins, active, (C, H, W)


def _plain_assembly(seds, morphs, origins, active, scene_shape):
    """The JAX package's slot loop with slicing, on torch tensors."""
    B, K, S = morphs.shape[:3]
    scene = seds.new_zeros((B, *scene_shape))
    for b in range(B):
        for k in range(K):
            if active[b, k]:
                oy, ox = (int(v) for v in origins[b, k])
                block = seds[b, k][:, None, None] * morphs[b, k][None]
                scene[b, :, oy:oy + S, ox:ox + S] = \
                    scene[b, :, oy:oy + S, ox:ox + S] + block
    return scene


def test_assemble_scene_forward_and_backward():
    seds, morphs, origins, active, shape = _scene_inputs()
    G = np.random.default_rng(1).standard_normal(
        (seds.shape[0], *shape)).astype(np.float32)

    def jax_scene(s, m, o, a):
        return jmr._assemble_scene(s, m, o, a, shape)

    ref = np.stack([np.asarray(jax_scene(*x)) for x in zip(
        seds, morphs, origins, active)])
    ref_g = [jax.grad(lambda s, m, o, a, g: jnp.sum(jax_scene(s, m, o, a)
                                                      * g), argnums=(0, 1))(
        *x) for x in zip(seds, morphs, origins, active, G)]

    ts = torch.from_numpy(seds).requires_grad_()
    tmo = torch.from_numpy(morphs).requires_grad_()
    scene = tmr.assemble_scene(ts, tmo, torch.from_numpy(origins),
                               torch.from_numpy(active), shape)
    _close(scene.detach(), ref, 1e-6)
    (scene * torch.from_numpy(G)).sum().backward()
    _close(ts.grad, np.stack([np.asarray(g[0]) for g in ref_g]), 1e-6)
    _close(tmo.grad, np.stack([np.asarray(g[1]) for g in ref_g]), 1e-6)
    assert float(ts.grad[1, 2].abs().max()) == 0.0
    assert float(tmo.grad[1, 2].abs().max()) == 0.0

    # against torch autograd of the plain slicing assembly
    ps = torch.from_numpy(seds).requires_grad_()
    pm = torch.from_numpy(morphs).requires_grad_()
    plain = _plain_assembly(ps, pm, origins, active, shape)
    (plain * torch.from_numpy(G)).sum().backward()
    _close(scene.detach(), plain.detach(), 1e-6)
    _close(ts.grad, ps.grad, 1e-6)
    _close(tmo.grad, pm.grad, 1e-6)


def test_assemble_scene_takes_a_strided_gradient():
    """A gradient whose columns are not contiguous (a crop of a wider
    array) reaches K4's plain version through a copy."""
    seds, morphs, origins, active, shape = _scene_inputs(seed=2)
    ts = torch.from_numpy(seds).requires_grad_()
    scene = tmr.assemble_scene(ts, torch.from_numpy(morphs),
                               torch.from_numpy(origins),
                               torch.from_numpy(active), shape)
    G = torch.randn(*scene.shape[:-1], 2 * scene.shape[-1],
                    generator=torch.Generator().manual_seed(3))[..., ::2]
    assert G.stride(-1) == 2
    (scene * G).sum().backward()
    ref = torch.from_numpy(seds).requires_grad_()
    (_plain_assembly(ref, torch.from_numpy(morphs), origins, active, shape)
     * G).sum().backward()
    _close(ts.grad, ref.grad, 1e-6)


# ---------------------------------------------------------------------------
# Init, loss and gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rotation", [0.0, ROT])
def test_multires_init_bit_for_bit(rotation):
    """Dyadic PSFs: the model PSF is the HR observation's own image."""
    (jf, jh, jl), (tf, th, tl) = _frames(rotation)
    B = 2
    rng = np.random.default_rng(4)
    datas = (rng.random((B, *th.shape)).astype(np.float32),
             rng.random((B, *tl.shape)).astype(np.float32))
    centers = blob_centers(tf, B)
    centers[1, 1] = np.nan
    centers[0, 2] = (2.0, 60.0)          # clamped into the frame
    for box in (15, 21):
        ji = jmr.multires_init((jh, jl), datas, centers, box_size=box,
                               n_slots=3)
        ti = tmr.multires_init((th, tl), datas, centers, box_size=box,
                               n_slots=3)
        for a, b in zip(ji, ti):
            assert b.dtype == np.asarray(a).dtype
            assert_array_equal(b, np.asarray(a))
    with pytest.raises(ValueError, match="n_slots"):
        tmr.multires_init((th, tl), datas, centers, box_size=15, n_slots=2)


@pytest.mark.parametrize("which", ["aligned", "rotated"])
def test_loss_and_gradient(which, request):
    setup = request.getfixturevalue(which)
    jobs, tobs, _, datas, weights = setup
    seds, morphs, origins, active = _init(setup)
    morphs = morphs * np.random.default_rng(5).uniform(
        0.5, 1.0, morphs.shape).astype(np.float32)
    jfit = jmr.MultiResFitter(jobs, box_size=15)
    tfit = tmr.MultiResFitter(tobs, box_size=15)
    xs = torch.from_numpy(seds).requires_grad_()
    xm = torch.from_numpy(morphs).requires_grad_()
    loss = tfit._loss(xs, xm, torch.from_numpy(origins),
                      torch.from_numpy(active),
                      tuple(map(torch.from_numpy, datas)),
                      tuple(map(torch.from_numpy, weights)))
    g_sed, g_morph = torch.autograd.grad(loss.sum(), (xs, xm))
    loss = loss.detach()
    vg = jax.value_and_grad(jfit._loss_one, argnums=(0, 1))
    for b in range(seds.shape[0]):
        val, (gs, gm) = vg(seds[b], morphs[b], origins[b], active[b],
                           tuple(d[b] for d in datas),
                           tuple(w[b] for w in weights))
        assert_allclose(float(loss[b]), float(val), rtol=1e-4)
        _close(g_sed[b], gs, 1e-4)
        _close(g_morph[b], gm, 1e-4)


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------
def test_well_conditioned(aligned):
    """A 1e-7 relative change of the images moves the port's losses by
    less than 1e-6 relative: card-vs-CPU and port-vs-JAX comparisons on
    this scene measure the implementations, not the scene."""
    _, tobs, _, datas, weights = aligned
    init = _init(aligned)
    fit = tmr.MultiResFitter(tobs, box_size=15)
    a = _np(fit.fit(datas, weights, *init, n_iter=15)[4])
    bumped = tuple(d * np.float32(1 + 1e-7) for d in datas)
    b = _np(fit.fit(bumped, weights, *init, n_iter=15)[4])
    assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()


@pytest.mark.parametrize("keep_best", [True, False])
def test_fit_aligned(aligned, keep_best):
    (jfit, jout), (tfit, tout), _ = _fits(aligned, keep_best=keep_best)
    _assert_fits_agree(jout, tout)
    assert tfit.iterations_run_ == 15
    assert tfit.last_box_half_ is None


def test_fit_rotated(rotated):
    (_, jout), (tfit, tout), _ = _fits(rotated)
    assert tfit.observations[1].renderer.isrot
    _assert_fits_agree(jout, tout)


def test_fit_box_grow(aligned):
    """Box 31 around a 21 x 21 PSF seed: the slots grow once."""
    (jfit, jout), (tfit, tout), _ = _fits(aligned, box=31, box_grow=1e-3)
    _assert_fits_agree(jout, tout)
    assert_array_equal(tfit.last_box_half_, jfit.last_box_half_)
    assert (tfit.last_box_half_ > 10).any()


def test_early_stop_equals_the_capped_run(aligned, monkeypatch):
    """At e_rel 1e-2 every blend converges well before the cap: the port
    stops after the segment where the last one froze and fills the loss
    rows; the outputs equal a run to the cap and the JAX fit's."""
    (_, jout), (tfit, tout), init = _fits(aligned, n_iter=60, e_rel=1e-2)
    assert tfit.iterations_run_ < 60
    _assert_fits_agree(jout, tout)
    _, tobs, _, datas, weights = aligned
    monkeypatch.setattr(tmr, "CHECK_EVERY", 1000)
    capped = tmr.MultiResFitter(tobs, box_size=15, e_rel=1e-2)
    full = capped.fit(datas, weights, *init, n_iter=60)
    assert capped.iterations_run_ == 60
    for a, b in zip(tout, full):
        assert_array_equal(_np(a), _np(b))


def test_stop_rule_freezes_like_jax():
    """Blends 39 and 40 of tools/multires_bench.py's batch (flux scales
    0.8 + 0.4 U of ``default_rng(0)``) at full width: on blend 40 the stop
    rule ``|dL| < e_rel |L|`` fires at iteration 25, on a plateau after
    adaprox's loss jumps, in both packages, and its HR render stays below
    the 10 dB SDR that blend 39 passes (chip_smoke's SDR check allows
    such a blend only where the CPU freezes it alike)."""
    from test_multiresolution import SDR

    rng = np.random.default_rng(0)
    scales = (0.8 + 0.4 * rng.random(64).astype(np.float32))[[39, 40]]
    setup = _setup(0.0, scales=scales, widths={})
    (jfit, jout), (tfit, tout), init = _fits(setup, n_iter=100, box=31,
                                             inactive=False)
    _assert_fits_agree(jout, tout)
    assert_array_equal(_np(tout[3]), [100, 25])
    datas = setup[3]
    render = tfit.render_batch(*tout[:2], init[2], init[3])[0]
    hr = [SDR(datas[0][b, 0], _np(render[b, 0])) for b in range(2)]
    assert hr[0] > 10 > hr[1]


def test_render_batch_records_and_log_norm(aligned):
    (jfit, jout), (tfit, tout), init = _fits(aligned)
    _, _, _, datas, weights = aligned
    seds, morphs, loss, iters, _ = (np.array(a) for a in jout)
    for j, t in zip(jfit.render_batch(seds, morphs, init[2], init[3]),
                    tfit.render_batch(seds, morphs, init[2], init[3])):
        _close(t, j, 1e-5)
    assert_allclose(tfit.log_norm(weights), jfit.log_norm(weights),
                    rtol=1e-12)
    jrec = jmr.multires_records(jfit, seds, morphs, init[2], init[3], loss,
                                iters, weights=weights)
    trec = tmr.multires_records(tfit, torch.from_numpy(seds),
                                torch.from_numpy(morphs), init[2], init[3],
                                torch.from_numpy(loss),
                                torch.from_numpy(iters), weights=weights)
    assert len(trec) == len(jrec)
    for a, b in zip(trec, jrec):
        assert a["iterations"] == b["iterations"]
        assert_allclose(a["logL"], b["logL"], rtol=1e-6)
        for key in ("flux", "centroid", "moments"):
            assert_allclose(a[key], b[key], rtol=1e-6, equal_nan=True)
    assert np.isnan(trec[1]["centroid"][2]).all()


def test_sed_step_floor(aligned):
    """The noise floor from the batch median of the positive weights,
    through each channel map (a zero-weight pixel left out)."""
    jobs, tobs, _, datas, weights = aligned
    w = (weights[0].copy(), weights[1] * 4.0)
    w[0][0, 0, :3] = 0.0
    tfit = tmr.MultiResFitter(tobs, box_size=15)
    got = tfit._sed_step_min(w)
    channels = list(tobs[0].model_frame.channels)
    assert_allclose(got[channels.index("hr")], 1 / np.sqrt(400.0), rtol=1e-7)
    assert_allclose(got[channels.index("lr")], 1 / np.sqrt(1600.0),
                    rtol=1e-7)
    init = _init(aligned)
    jout = jmr.MultiResFitter(jobs, box_size=15).fit(datas, w, *init,
                                                      n_iter=3)
    tout = tfit.fit(datas, w, *init, n_iter=3)
    _assert_fits_agree(jout, tout)


def test_deblend_multires_detects_like_jax(aligned):
    jobs, tobs, _, datas, weights = aligned
    jrec, js, jm, jo, ja, jl = jmr.deblend_multires(
        jobs, datas, weights, centers=None, box_size=15, n_slots=4,
        n_iter=15)
    trec, ts, tmo, to, ta, tl = tmr.deblend_multires(
        tobs, datas, weights, centers=None, box_size=15, n_slots=4,
        n_iter=15)
    assert_array_equal(ta, np.asarray(ja))
    assert_array_equal(to, np.asarray(jo))
    assert ta.sum() >= 2 * len(SCALES)
    assert_allclose(_np(tl), np.asarray(jl), rtol=1e-4)
    for a, b in zip(trec, jrec):
        assert_allclose(a["logL"], b["logL"], rtol=1e-4)
        assert a["iterations"] == b["iterations"]


def test_deblend_multires_with_a_catalog(aligned):
    jobs, tobs, tf, datas, weights = aligned
    centers = blob_centers(tf, len(SCALES))
    centers[2, 1] = np.nan
    out = [pkg.deblend_multires(obs, datas, weights, centers=centers,
                                box_size=15, n_slots=3, n_iter=10)
           for pkg, obs in ((jmr, jobs), (tmr, tobs))]
    (jrec, *jrest), (trec, *trest) = out
    assert_array_equal(trest[2], jrest[2])
    assert_array_equal(trest[3], jrest[3])
    assert not trest[3][2, 1]
    for a, b in zip(trec, jrec):
        assert_allclose(a["logL"], b["logL"], rtol=1e-4)
        assert_allclose(a["flux"], b["flux"], rtol=1e-4, atol=1e-4)


def test_fit_through_converted_observations(aligned):
    """``convert.observations_from_jax`` gives observations the port fits
    like the JAX package's."""
    jobs, _, _, datas, weights = aligned
    conv = convert.observations_from_jax(jobs, device="cpu")
    tm.Frame.from_observations([conv[1], conv[0]], obs_id=1)
    init = _init(aligned)
    jout = jmr.MultiResFitter(jobs, box_size=15).fit(datas, weights, *init,
                                                     n_iter=10)
    tout = tmr.MultiResFitter(conv, box_size=15).fit(datas, weights, *init,
                                                     n_iter=10)
    _assert_fits_agree(jout, tout)


def test_fitter_rejects_bad_input(aligned):
    _, tobs, _, datas, weights = aligned
    with pytest.raises(ValueError, match="odd"):
        tmr.MultiResFitter(tobs, box_size=14)
    fit = tmr.MultiResFitter(tobs, box_size=15)
    with pytest.raises(ValueError, match="per observation"):
        fit.fit(datas[:1], weights, *_init(aligned), n_iter=1)
