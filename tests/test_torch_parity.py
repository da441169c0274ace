"""Parity of scarlet_tpu_torch with the JAX package where the port lacked
a name, or where its card geometry refused a shape the JAX package fits,
on the CPU and on the same numpy inputs:

- ``ConvolutionRenderer.convolution_bounds``
  (scarlet_tpu/models/renderer.py:190-197): the filter clip bounds of the
  difference kernel's first channel, equal arrays;
- ``optim.adaprox_step(prox_e_rel=...)`` (scarlet_tpu/optim.py:135-160):
  accepted and unused in both packages, so every value gives the update
  of the default;
- boxes past 170 pixels, which K4's card geometry refused before its
  tiled route (csrc/grad.cu): the gradient gather at box 171 against the
  JAX kernel in interpret mode, and a lite fit at box 181 on a 180 x 180
  scene (a large galaxy of ``testing.large_galaxy``): the JAX package's
  engine setup carried over by ``convert.from_jax`` and fitted 10
  iterations in each package.

On the CPU the port's wrappers run their plain versions; the card holds
the kernels to those (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import scarlet_tpu as st
from scarlet_tpu import lite as jlite
from scarlet_tpu import optim as joptim
from scarlet_tpu.lite import engine as jeng
from scarlet_tpu.ops import pallas_kernels as pk
from scarlet_tpu_torch import convert
from scarlet_tpu_torch import models as tm
from scarlet_tpu_torch import optim as toptim
from scarlet_tpu_torch.lite import engine as teng
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.ops import kernels as kn
from scarlet_tpu_torch.testing import generate_blend, large_galaxy

# the large-box fit: a 180 x 180 scene whose single bucket is forced to
# the cap max(H, W) + 1
BIG_SCENE, BIG_BOX, BIG_ITERS = 180, 181, 10


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ConvolutionRenderer.convolution_bounds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_convolution_bounds_match_jax(dtype):
    """A generated blend's observation matched to a frame of a narrower
    Gaussian PSF, in both packages: the same four clip arrays (dy start,
    dy end, dx start, dx end) over the difference kernel's taps."""
    d = generate_blend(np.random.default_rng(2), shape=(3, 24, 20),
                       n_sources=2)
    ch = list(d["filters"])
    out = []
    for pkg, kw in ((st, {}), (tm, dict(device="cpu"))):
        frame = pkg.Frame(d["images"].shape, channels=ch,
                          psf=pkg.GaussianPSF(sigma=0.8, boxsize=15),
                          dtype=dtype)
        obs = pkg.Observation(d["images"].astype(dtype), ch,
                              psf=pkg.ImagePSF(d["psfs"].astype(dtype)),
                              **kw).match(frame)
        assert type(obs.renderer).__name__ == "ConvolutionRenderer"
        out.append(obs.renderer.convolution_bounds)
    (jb, tb) = out
    assert len(tb) == len(jb) == 4
    for t, j in zip(tb, jb):
        assert_array_equal(t, np.asarray(j))
    assert tb[0].size > 1 and tb[0].max() > 0


# ---------------------------------------------------------------------------
# adaprox_step(prox_e_rel=...)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_prox_iter", [1, 3])
@pytest.mark.parametrize("prox_e_rel", [1e-6, 1e-2, 0.5])
def test_adaprox_step_takes_prox_e_rel_like_jax(prox_e_rel, max_prox_iter):
    """The keyword is accepted, as in the JAX package, and changes nothing:
    the update and the moments at any prox_e_rel are the default's, and
    agree with JAX's (float32, rtol 1e-6)."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, 9, 9)).astype(np.float32)
    g = rng.normal(size=(3, 9, 9)).astype(np.float32)

    def run(pkg, to, prox, **kw):
        state = pkg.init_adaprox_state(to(x))
        return pkg.adaprox_step(to(x), to(g), 1, state, 0.05, prox=prox,
                                max_prox_iter=max_prox_iter, **kw)

    tx = torch.from_numpy
    tprox = lambda z, s: torch.clamp_min(z - 0.01, 0.0)  # noqa: E731
    jprox = lambda z, s: jnp.maximum(z - 0.01, 0.0)      # noqa: E731
    got, gstate = run(toptim, tx, tprox, prox_e_rel=prox_e_rel)
    ref, rstate = run(toptim, tx, tprox)
    assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(gstate, rstate))
    jx, jstate = run(joptim, jnp.asarray, jprox, prox_e_rel=prox_e_rel)
    assert_allclose(got.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)
    for a, b in zip(gstate, jstate):
        assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# Boxes past 170 pixels
# ---------------------------------------------------------------------------
def test_grad_gather_at_box_171_matches_pallas():
    """Two components of box 171 on a 3 x 170 x 172 gradient padded by 8,
    their boxes overhanging the edges: the port (on the CPU its plain
    version) against the JAX kernel in interpret mode, g_morph to float32
    roundoff (1e-6 relative, as tests/test_torch_kernels.py holds box 59)
    and g_sed within 1e-6 of sum |g * morph|; the card's geometry for the
    same shape is the tiled route."""
    rng = np.random.default_rng(171)
    C, H, W, P, box = 3, 170, 172, 8, 171
    seds = rng.uniform(0.1, 2, (2, C)).astype(np.float32)
    morphs = rng.uniform(0, 1, (2, box, box)).astype(np.float32)
    origins = np.array([[-5, 3], [2, -7]], np.int32)
    gpad = np.pad(rng.normal(size=(C, H, W)).astype(np.float32),
                  ((0, 0), (P, P), (P, P)))
    t = [torch.from_numpy(a[None]) for a in (gpad, seds, morphs, origins)]
    gs, gm = kn.grad_gather(*t, P)
    scale = kn.grad_gather(t[0].abs(), *t[1:], P)[0]
    rs, rm = (np.asarray(a) for a in pk.grad_gather(
        jnp.asarray(gpad), jnp.asarray(seds), jnp.asarray(morphs),
        jnp.asarray(origins), P, interpret=True))
    assert_allclose(gm[0].numpy(), rm, rtol=1e-6, atol=1e-6)
    assert np.all(np.abs(gs[0].numpy() - rs) <= 1e-6 * scale[0].numpy()
                  + 1e-6)
    geo = kn.grad_geometry(1, 2, C, H + 2 * P, W + 2 * P, box, box)
    assert geo.route == "tiled" and geo.R == 4


@pytest.fixture(scope="module")
def big_fits(_few_threads):
    """The large galaxy (3 bands, 180 x 180) with a second source, set up
    by the JAX package's lite init and ``engine_setup(box_size=181)``,
    carried to the port, and fitted BIG_ITERS iterations in each."""
    img, var, psfs = large_galaxy(seed=3, bands=3, size=BIG_SCENE,
                                  radius=30.0)
    weights = (1.0 / var).astype(np.float32)
    mpsf = jlite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = jlite.LiteObservation(img, var, weights, psfs, model_psf=mpsf)
    src = jlite.init_all_sources_main(obs, [(90, 90), (40, 130)])
    src = jlite.parameterize_sources(src, obs, jlite.init_adaprox_component)
    config, data, state = jlite.LiteBlend(src, obs).engine_setup(
        box_size=BIG_BOX)
    out_j, loss_j = jeng.fit_scan(state, data, config, BIG_ITERS)
    cfg, d, s = convert.from_jax(dataclasses.asdict(config),
                                 jax.device_get(data), jax.device_get(state),
                                 device="cpu")
    out_t, loss_t = teng.fit_scan(s, d, cfg, BIG_ITERS)
    return cfg, (out_j, np.asarray(loss_j)), (out_t, to_numpy(loss_t)), \
        (d, s)


def test_lite_fit_at_box_181_matches_jax(big_fits):
    """The fit of three components (two of the galaxy's, one of the second
    source) in one bucket of box 181: losses within 1e-5, seds within 1e-5
    and morphologies within 1e-4 of their largest value (measured 2.7e-7,
    1.4e-6 and 1.0e-5: the two packages' FFT roundoff through 10 steps of
    272-pass projections), iterations equal; the loss improves.  K4's
    geometry at this shape is the tiled route, four warps a component."""
    cfg, (out_j, loss_j), (out_t, loss_t), _ = big_fits
    assert cfg.scene_shape == (3, BIG_SCENE, BIG_SCENE)
    assert cfg.box_shapes == ((BIG_BOX, BIG_BOX),)
    assert loss_t.shape == loss_j.shape == (BIG_ITERS,)
    assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert np.isfinite(loss_t).all() and loss_t[-1] > loss_t[0]
    for a, b in zip(out_t.seds, out_j.seds):
        assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    for a, b in zip(out_t.morphs, out_j.morphs):
        b = np.asarray(b)
        assert np.abs(to_numpy(a) - b).max() <= 1e-4 * np.abs(b).max()
    assert_array_equal(to_numpy(out_t.it), np.asarray(out_j.it))
    geo = kn.grad_geometry(1, cfg.bucket_counts[0], *cfg.scene_shape,
                           *cfg.box_shapes[0])
    assert geo.route == "tiled" and geo.R == 4 and geo.G == 2


def test_box_181_fit_turns_on_one_rounding_of_the_model(big_fits):
    """Why no two float32 convolutions fit this blend alike (ROADMAP.md
    Queue 3, F4): the first SED gradient of the galaxy's first component
    is 4.4e-3 to 1.6e-2 in the three bands on the CPU (7.1e-3 to 1.7e-2
    with float64 convolutions) against sums |g * morph| of 2.4e3 to
    4.1e3, and adaprox's first step moves a SED by a fixed amount in the
    gradient's sign.  So the fit with every convolution in float64 stays
    within 1e-6 of the float32 fit (measured 1.3e-7), while the fit with
    every convolution's result times 1 - u (u = 2^-24, one float32
    rounding of its scale) parts from it by more than 1e-2 (measured
    1.7e-2)."""
    from scarlet_tpu_torch.testing import convolution_probe
    from scarlet_tpu_torch.testing.galaxy import UNIT_ROUNDOFF

    cfg, _, (_, loss_t), (d, s) = big_fits

    def gap(**probe):
        with convolution_probe(**probe):
            loss = to_numpy(teng.fit_scan(s, d, cfg, BIG_ITERS)[1])
        return np.abs(loss - loss_t).max() / np.abs(loss_t).max()

    assert gap(exact=True) <= 1e-6
    assert gap(scale=-UNIT_ROUNDOFF) > 1e-2
