"""The port's proximal operators, constraints and Bessel ``kv`` against the
JAX package on the CPU, on the same seeded numpy inputs.

Tolerances: the monotonic projection (``build_prox_monotonic``,
``MonotonicityConstraint`` with and without ``fit_center_radius``,
``use_mask``) bit for bit, in float32 and in float64, against the JAX
package's functions run op by op (``jax.disable_jit()``), and within
2 ulp of their compiled form: XLA's CPU compiler contracts each
pass's multiply-add into a fused multiply-add, rounding once where the
port (and K1 on the card) rounds the product and the sum.  The port's
sequential sweep equals its projection bit for bit, and the JAX
package's (its native library, also contracted) within 2 ulp.  The mask
with orphan interpolation, the elementwise proxes, the thresholds and the
flat-form helpers bit for bit; the symmetries, the cone and the disk-SED
projections to 1e-6 of the largest value (float32 roundoff: FFT and sum
orders differ); the other constraints to 1e-15 (float64) and 1e-6
(float32) of the largest value; ``kv`` and its gradient to 1e-12
relative in float64 (the node tables are the same; only exp and sum
orders differ).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

import scarlet_tpu as st
import scarlet_tpu.operator as joperator
from scarlet_tpu.ops import prox as jprox
from scarlet_tpu.ops.special import kv as jkv
from scarlet_tpu_torch import models as tm
from scarlet_tpu_torch import operator as toperator
from scarlet_tpu_torch.ops import prox as tprox
from scarlet_tpu_torch.ops.special import kv as tkv

F32_RTOL = 1e-6
ULP2 = {np.float32: 2 * 2.0 ** -23, np.float64: 2 * 2.0 ** -52}


def _morph(shape, seed, dtype=np.float64, peak=None):
    """A noisy peaked profile with negative pixels; ``peak`` (y, x) puts
    the brightest pixel there (default: the box center)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    py, px = peak if peak is not None else (H // 2, W // 2)
    yy, xx = np.mgrid[:H, :W]
    prof = np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / (2 * (H / 6) ** 2))
    out = prof + 0.1 * rng.normal(size=shape)
    out[py, px] = out.max() + 0.5
    return out.astype(dtype)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _same(a, b):
    assert_array_equal(np.asarray(a), b.numpy() if isinstance(
        b, torch.Tensor) else np.asarray(b))


def _eager(fn, *args):
    """``fn(*args)`` of the JAX package run op by op (no XLA fusion)."""
    with jax.disable_jit():
        return np.asarray(fn(*args))


def _ulps(a, b, dtype):
    """Within 2 ulp of the largest value (a fused multiply-add's last
    bit per pass)."""
    _close(a, b, rtol=ULP2[dtype])


def _close(a, b, rtol=F32_RTOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    assert_allclose(b, a, rtol=0, atol=rtol * max(np.abs(a).max(), 1e-30))


# ---------------------------------------------------------------------------
# the monotonic projection (K1's function on the CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nw,min_grad,shape", [
    ("angle", 0.0, (21, 21)), ("flat", 0.0, (31, 31)),
    ("angle", 0.1, (20, 25)), ("nearest", 0.1, (21, 21)),
    ("flat", 0.1, (41, 41))])
def test_build_prox_monotonic_bitwise(nw, min_grad, shape, dtype):
    m = _morph(shape, 1, dtype)
    center = (shape[0] // 2 - 1, shape[1] // 2 + 1)
    ja, ta = _both(m)
    jprox_fn = jprox.build_prox_monotonic(shape, nw, min_grad, center)
    tout = tprox.build_prox_monotonic(shape, nw, min_grad, center)(ta, 0)
    assert tout.dtype == ta.dtype
    _same(_eager(jprox_fn, ja, 0), tout)
    _ulps(jprox_fn(ja, 0), tout, dtype)


# peaks inside the window, on its edge and corner, and outside it
@pytest.mark.parametrize("shape,radius,peak,dtype", [
    ((21, 21), 1, (10, 10), np.float64), ((21, 21), 1, (9, 11), np.float32),
    ((21, 21), 1, (11, 9), np.float64), ((21, 21), 1, (12, 10), np.float32),
    ((20, 24), 1, (9, 13), np.float32), ((3, 5), 2, (0, 4), np.float64)])
def test_monotonicity_fit_center_bitwise(shape, radius, peak, dtype):
    """The candidate tables in the JAX order (window and candidates
    clipped at the box edge) and the device-side index give the JAX
    package's ``lax.switch`` branch, bit for bit."""
    m = _morph(shape, 2, dtype, peak=peak)
    ja, ta = _both(m)
    kw = dict(neighbor_weight="angle", min_gradient=0.0,
              fit_center_radius=radius)
    jc = st.MonotonicityConstraint(**kw)
    tc = tm.MonotonicityConstraint(**kw)
    tout = tc(ta, 0)
    _same(_eager(jc, ja, 0), tout)
    _ulps(jc(ja, 0), tout, dtype)
    assert tc.candidate_index(ta).shape == (1, 1)


@pytest.mark.parametrize("kw", [
    dict(neighbor_weight="flat", min_gradient=0.1),
    dict(neighbor_weight="angle", min_gradient=0.0, use_mask=True),
    dict(neighbor_weight="angle", min_gradient=0.1, use_mask=True,
         fit_center_radius=1)])
def test_monotonicity_constraint_bitwise(kw):
    for seed in range(2):
        m = _morph((21, 21), 10 + seed, np.float32)
        ja, ta = _both(m)
        jc = st.MonotonicityConstraint(**kw)
        tout = tm.MonotonicityConstraint(**kw)(ta, 0)
        _same(_eager(jc, ja, 0), tout)
        _ulps(jc(ja, 0), tout, np.float32)


@pytest.mark.parametrize("nw,min_grad", [("flat", 0.1), ("angle", 0.0)])
def test_sequential_sweep(nw, min_grad):
    """The reference's sequential sweep equals the Jacobi projection's
    fixed point bit for bit, and the JAX package's (its native library)
    within 2 ulp."""
    shape = (15, 17)
    m = _morph(shape, 3, np.float32)
    tout = tprox.prox_weighted_monotonic_seq(shape, nw, min_grad)(m, 0)
    center = ((shape[0] - 1) // 2, (shape[1] - 1) // 2)
    _same(tprox.build_prox_monotonic(shape, nw, min_grad, center)(
        torch.from_numpy(m), 0), tout)
    _ulps(jprox.prox_weighted_monotonic_seq(shape, nw, min_grad)(m, 0), tout,
          np.float32)


@pytest.mark.parametrize("max_iter,center_radius,variance", [
    (3, 1, 0.0), (1, 0, 0.0), (3, 2, 0.05)])
def test_monotonic_mask_orphans_bitwise(max_iter, center_radius, variance):
    """``prox_monotonic_mask(max_iter > 0)``: the orphan interpolation and
    the fill continued from it (the JAX package's native fill)."""
    for seed in range(4):
        m = _morph((23, 21), 20 + seed, np.float32)
        kw = dict(center=(11, 10), center_radius=center_radius,
                  variance=variance, max_iter=max_iter)
        jv, jm, jb = jprox.prox_monotonic_mask(m, 0, **kw)
        tv, tmod, tb = tprox.prox_monotonic_mask(m, 0, **kw)
        assert_array_equal(jv, tv)
        assert_array_equal(jm, tmod)
        assert_array_equal(jb, tb)
        assert tmod.dtype == m.dtype


def test_monotonic_mask_constraint_bitwise():
    m = _morph((21, 21), 30, np.float32)
    ja, ta = _both(m)
    kw = dict(center=(10, 10), center_radius=1, max_iter=3)
    _same(st.MonotonicMaskConstraint(**kw)(ja, 0),
          tm.MonotonicMaskConstraint(**kw)(ta, 0))


# ---------------------------------------------------------------------------
# elementwise proxes and thresholds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("prox_plus", {}), ("prox_hard", dict(thresh=0.3)),
    ("prox_hard", dict(thresh=2.0, type="relative")),
    ("prox_hard_plus", dict(thresh=0.3)), ("prox_soft", dict(thresh=0.2)),
    ("prox_soft_plus", dict(thresh=0.2, type="relative")),
    ("prox_unity", {}), ("prox_unity", dict(axis=0)),
    ("prox_unity_plus", dict(axis=1))])
def test_elementary_proxes(name, kw):
    m = _morph((9, 11), 4)
    ja, ta = _both(m)
    step = 0.25
    if name == "prox_plus":
        jout, tout = getattr(jprox, name)(ja), getattr(tprox, name)(ta)
    elif name.startswith("prox_unity"):
        jout = getattr(jprox, name)(ja, step, **kw)
        tout = getattr(tprox, name)(ta, step, **kw)
    else:
        jout = getattr(jprox, name)(ja, step, **kw)
        tout = getattr(tprox, name)(ta, step, **kw)
    _close(jout, tout, rtol=1e-15)


@pytest.mark.parametrize("n_pixels", [60, 800, 2500])
def test_threshold_and_prox_threshold(n_pixels):
    """The host threshold and the device form (the bin count shrinks for
    fewer than 500 positive pixels)."""
    rng = np.random.default_rng(n_pixels)
    side = int(np.ceil(np.sqrt(n_pixels)))
    m = np.exp(rng.normal(0, 2, size=(side, side)))
    m[rng.random((side, side)) < 0.3] *= -1
    jt = jprox.threshold(m)
    tt = tprox.threshold(m)
    assert jt[1] == tt[1]
    assert_allclose(tt[0], jt[0], rtol=1e-15)
    ja, ta = _both(m)
    _same(jprox.prox_threshold(ja, 0), tprox.prox_threshold(ta, 0))
    _same(st.ThresholdConstraint()(ja, 0), tm.ThresholdConstraint()(ta, 0))


# ---------------------------------------------------------------------------
# symmetry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(15, 15), (14, 15), (16, 12)])
@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_soft_symmetry(shape, strength):
    m = _morph(shape, 5, np.float32)
    ja, ta = _both(m)
    _close(jprox.prox_soft_symmetry(ja, 0, strength=strength),
           tprox.prox_soft_symmetry(ta, 0, strength=strength))
    _close(st.SymmetryConstraint(strength)(ja, 0),
           tm.SymmetryConstraint(strength)(ta, 0))


@pytest.mark.parametrize("shift", [(0.3, -0.2), (-0.45, 0.1)])
def test_kspace_symmetry(shift):
    m = np.clip(_morph((17, 16), 6, np.float32), 0, None)
    ja, ta = _both(m)
    _close(jprox.prox_kspace_symmetry(ja, 0, shift=shift),
           tprox.prox_kspace_symmetry(ta, 0, shift=shift))


@pytest.mark.parametrize("algorithm,kw", [
    ("sdss", {}), ("soft", dict(strength=0.7)),
    ("kspace", dict(shift=(0.2, 0.1))), ("kspace", {}),
    ("sdss", dict(fill=0.0))])
@pytest.mark.parametrize("center", [(8, 8), (6, 10), (11, 5), None])
def test_uncentered_symmetry(algorithm, kw, center):
    m = np.clip(_morph((17, 17), 7, np.float32, peak=center), 0, None)
    ja, ta = _both(m)
    _close(jprox.prox_uncentered_symmetry(ja, 0, center=center,
                                          algorithm=algorithm, **kw),
           tprox.prox_uncentered_symmetry(ta, 0, center=center,
                                          algorithm=algorithm, **kw))


def test_uncentered_symmetry_rejects_unknown_algorithm():
    with pytest.raises(ValueError):
        tprox.prox_uncentered_symmetry(torch.zeros(5, 5), 0, center=(1, 1),
                                       algorithm="nope")


# ---------------------------------------------------------------------------
# cone, disk SEDs, flat-form helpers
# ---------------------------------------------------------------------------
def test_prox_cone():
    rng = np.random.default_rng(8)
    n = 5
    G = np.eye(n) - np.eye(n, k=1)
    X = rng.normal(size=(4, n))
    _close(jprox.prox_cone(X, 0, G=G), tprox.prox_cone(X, 0, G=G),
           rtol=1e-12)


class _Peak:
    def __init__(self, bulge, disk):
        self.components = {"bulge": _Idx(bulge), "disk": _Idx(disk)}

    def __getitem__(self, k):
        return self.components[k]


class _Idx:
    def __init__(self, index):
        self.index = index


class _Peaks:
    peaks = [_Peak(0, 1), _Peak(2, 3)]


def test_disk_sed_projections():
    rng = np.random.default_rng(9)
    bulge, disk = rng.random(6), rng.random(6)
    for name in ("project_disk_sed", "project_disk_sed_mean"):
        _close(getattr(jprox, name)(bulge, disk),
               getattr(tprox, name)(bulge, disk), rtol=1e-15)
    X = rng.random((6, 4))
    for alg in ("project_disk_sed", "project_disk_sed_mean"):
        _close(jprox.proximal_disk_sed(X, 0, _Peaks,
                                       getattr(jprox, alg)),
               tprox.proximal_disk_sed(X, 0, _Peaks, getattr(tprox, alg)),
               rtol=1e-15)


def test_flat_form_helpers():
    jo, js, ji = jprox.getOffsets(7)
    to, ts, ti = tprox.getOffsets(7)
    assert (jo, js, ji) == (to, ts, ti)
    arr = _morph((6, 7), 11)
    for a, b in zip(jprox.diagonalizeArray(arr), tprox.diagonalizeArray(arr)):
        assert_array_equal(a, b)
    for a, b in zip(jprox.diagonalizeArray(arr.ravel(), shape=(6, 7)),
                    tprox.diagonalizeArray(arr.ravel(), shape=(6, 7))):
        assert_array_equal(a, b)
    for nw in ("flat", "angle", "nearest"):
        assert_array_equal(
            jprox.getRadialMonotonicWeights((9, 8), nw, center=(4, 3)),
            tprox.getRadialMonotonicWeights((9, 8), nw, center=(4, 3)))
    assert_array_equal(jprox.get_center(arr, (3, 3), 2),
                       tprox.get_center(arr, (3, 3), 2))


# ---------------------------------------------------------------------------
# the remaining constraints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda mod: mod.PositivityConstraint(),
    lambda mod: mod.PositivityConstraint(zero=1e-3),
    lambda mod: mod.NormalizationConstraint("sum"),
    lambda mod: mod.NormalizationConstraint("max"),
    lambda mod: mod.L0Constraint(0.2),
    lambda mod: mod.L1Constraint(0.1, type="relative"),
    lambda mod: mod.CenterOnConstraint(),
    lambda mod: mod.CenterOnConstraint(tiny=5.0),
    lambda mod: mod.LeakyConstraint(mod.PositivityConstraint(), leak=0.1),
    lambda mod: mod.Constraint(lambda X, step: X * step),
    lambda mod: mod.ConstraintChain(
        mod.MonotonicityConstraint("angle", 0.0), mod.PositivityConstraint(),
        mod.CenterOnConstraint(), mod.NormalizationConstraint("max"),
        repeat=2)])
def test_constraints(make):
    for dtype in (np.float32, np.float64):
        m = _morph((13, 15), 12, dtype)
        m[6, 7] = -1.0        # a non-positive center for CenterOn
        ja, ta = _both(m)
        jout = make(st)(ja, 0.5)
        tout = make(tm)(ta, 0.5)
        assert tout.dtype == ta.dtype
        _close(jout, tout, rtol=1e-15 if dtype == np.float64 else F32_RTOL)


# ---------------------------------------------------------------------------
# kv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nu", [-0.8, 0.0, 0.5, 1.7, 3.9])
def test_kv_values_and_gradient(nu):
    x = np.geomspace(0.02, 30, 41)
    _close(jkv(nu, jnp.asarray(x)), tkv(nu, torch.from_numpy(x)),
           rtol=1e-12)
    jg = jax.grad(lambda t: jnp.sum(jkv(nu, t) * jnp.arange(41.0)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tkv(nu, xt) * torch.arange(41.0, dtype=torch.float64)).sum().backward()
    _close(jg, xt.grad, rtol=1e-12)


def test_kv_no_gradient_to_nu():
    nu = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    x = torch.linspace(0.1, 3, 7, dtype=torch.float64)
    tkv(nu, x).sum().backward()
    assert nu.grad is None or float(nu.grad) == 0.0


def test_operator_reexports_every_name():
    names = [n for n in dir(joperator) if not n.startswith("_")
             and n not in ("annotations",)]
    missing = [n for n in names if not hasattr(toperator, n)]
    assert not missing, missing
