"""The port's multiprocess host pipeline (``parallel.pipeline``) against
its in-process path and the JAX package's, on the CPU.

Inputs: generated blends as the pipeline's blobs, one per seed 0, 1, 2
(``generate_blend(default_rng(seed))``, the lite tests' blends).  Not
the stream of ``default_rng(7)``: its first blend has a band whose first
SED gradient is a cancellation (the port's +1.0e-4 against JAX's
-8.0e-5, where the blend's largest is 7.4e-2: the two FFTs' roundoff),
and adaprox's first step turns either sign into a full step, so the two
packages part by 9e-4 in logL within 10 iterations (ROADMAP Queue 3's
least-squares-start trap, in the lite fit).

Tolerances: the pipeline against the port's own in-process path (the
same ops on the same device) to rtol 1e-5 in logL and fluxes, iterations
equal (bit for bit on an idle machine; torch's CPU reductions and MKL's
FFTs split their work over the threads they get, which vary with the
machine's load: tests/test_torch_cli.py); against the JAX package's
in-process path to rtol 1e-4 in logL (tests/test_pipeline.py:49-50),
iterations equal; the worker-built blends' init decisions equal to
JAX's and their SEDs and morphologies to 1e-5.  The JAX side is handed the port's noise
levels (``noise_rms``): its float32 mean of the variance's square root
drifts by ~1e-5 relative (ROADMAP Queue 3), which alone moves an
initial morphology by 1e-5.

The JAX package is imported inside the fixtures: the pipeline's spawned
workers import this module to unpickle its blend constructors, and
need no JAX.
"""
import dataclasses
import json
import os
import uuid

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu_torch import parallel as tpar
from scarlet_tpu_torch.lite import engine
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.testing import generate_blend

MAX_ITER = 10


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _blobs(n):
    out = []
    for seed in range(n):
        d = generate_blend(np.random.default_rng(seed))
        out.append({"images": d["images"], "variance": d["variance"],
                    "psfs": d["psfs"],
                    "centers": [(float(r["y"]), float(r["x"]))
                                for r in d["catalog"]]})
    return out


def _recording_build(blob, record_dir):
    """Build as ``build_lite_blend`` does, after writing what the worker
    sees of CUDA to ``record_dir``."""
    with open(os.path.join(record_dir, f"{uuid.uuid4().hex}.json"),
              "w") as f:
        json.dump({"pid": os.getpid(), "threads": torch.get_num_threads(),
                   "CUDA_VISIBLE_DEVICES":
                       os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "device_count": torch.cuda.device_count()}, f)
    return tpar.build_lite_blend(blob)


def _failing_build(blob):
    raise ValueError("no blend here")


@pytest.fixture(scope="module")
def jax_blends():
    """The JAX package's ``build_lite_blend`` on the blobs, its
    ``LiteObservation`` given the port's ``noise_rms`` (torch's float32
    mean of the variance's square root): per blend the components' init
    (box, kind, SED, morphology), then the blends' in-process fit
    (``pack_blends``, ``fit_batch_device_converged``, ``unpack_blends``):
    (inits, iterations, final logLs)."""
    from scarlet_tpu import lite as jlite
    from scarlet_tpu import parallel as jpar

    class Observation(jlite.LiteObservation):
        def __init__(self, images, variance, *args, **kwargs):
            kwargs.setdefault("noise_rms", torch.sqrt(torch.from_numpy(
                np.asarray(variance, np.float32))).mean(dim=(1, 2)).numpy())
            super().__init__(images, variance, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlite, "LiteObservation", Observation)
        blends = [jpar.build_lite_blend(b) for b in _blobs(3)]
    inits = [[(c.bbox, type(c).__name__, np.asarray(c.sed),
               np.asarray(c.morph)) for c in b.components] for b in blends]
    cfg, data, state = jpar.pack_blends(blends, platform="cpu")
    out, losses = jpar.fit_batch_device_converged(state, data, cfg,
                                                  MAX_ITER, check_every=25)
    jpar.unpack_blends(blends, out, losses, reweight=True)
    return inits, [b.it for b in blends], [b.loss[-1] for b in blends]


def test_engine_setup_platform_picks_the_branches_only():
    """``platform="cuda"`` on CPU tensors: the card's kernel branches, the
    same tensors bit for bit as ``platform="cpu"``; ``platform`` defaults
    to the device's type."""
    blend = tpar.build_lite_blend(_blobs(1)[0])
    card = blend.engine_setup(device="cpu", platform="cuda")
    host = blend.engine_setup(device="cpu", platform="cpu")
    default = blend.engine_setup(device="cpu")
    branches = ("use_pallas", "use_pallas_scene", "packed_morphs")
    assert all(getattr(card[0], f) for f in branches)
    assert not any(getattr(host[0], f) for f in branches)
    assert card[0].conv_mode == host[0].conv_mode == "fft"
    assert dataclasses.replace(card[0], **{f: False for f in branches}) \
        == host[0] == default[0]
    for a, b in zip(card[1:], host[1:]):
        leaves = []
        engine.map_tree(lambda x, y: leaves.append((x, y)), a, b)
        for x, y in leaves:
            assert x.device.type == "cpu"
            assert x.dtype == y.dtype
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="platform"):
        blend.engine_setup(device="cpu", platform="tpu")


def test_build_lite_blend_matches_jax(jax_blends):
    inits = jax_blends[0]
    for blob, init in zip(_blobs(2), inits):
        tb = tpar.build_lite_blend(blob)
        assert len(tb.components) == len(init)
        for ct, (bbox, kind, sed, morph) in zip(tb.components, init):
            assert ct.bbox == bbox
            assert type(ct).__name__ == kind
            assert_allclose(to_numpy(ct.sed), sed, rtol=1e-5, atol=1e-5)
            assert_allclose(to_numpy(ct.morph), morph, atol=1e-5)


@pytest.fixture(scope="module")
def pipe():
    """One pool of two spawned workers for the module's runs, the fit on
    the CPU."""
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    with tpar.BlendPipeline(n_workers=2, fit_device="cpu") as p:
        yield p, (before, os.environ.get("CUDA_VISIBLE_DEVICES"))


@pytest.fixture(scope="module")
def streamed(pipe, tmp_path_factory):
    """Three blobs through ``deblend_stream`` (two workers, the fit on the
    CPU) on the module's pool, with what each worker saw of CUDA."""
    pipeline, env = pipe
    asked = []

    class Shared:
        """``deblend_stream``'s pool: the module's, left open."""

        def __init__(self, n_workers, fit_device):
            asked.append((n_workers, fit_device))

        def __enter__(self):
            return pipeline

        def __exit__(self, *exc):
            pass

    record_dir = str(tmp_path_factory.mktemp("workers"))
    blobs = _blobs(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpar.pipeline, "BlendPipeline", Shared)
        records = tpar.deblend_stream(
            blobs, _recording_build, build_kwargs={"record_dir": record_dir},
            n_workers=2, fit_device="cpu", max_iter=MAX_ITER)
    assert asked == [(2, "cpu")]
    seen = []
    for name in sorted(os.listdir(record_dir)):
        with open(os.path.join(record_dir, name)) as f:
            seen.append(json.load(f))
    return blobs, records, seen, env


def test_stream_matches_in_process(streamed):
    blobs, records, _, _ = streamed
    blends = [tpar.build_lite_blend(b) for b in blobs]
    cfg, data, state = tpar.pack_blends(blends, device="cpu")
    out, losses = tpar.fit_batch_device_converged(state, data, cfg,
                                                  MAX_ITER, check_every=25)
    tpar.unpack_blends(blends, out, losses, reweight=True)
    assert len(records) == len(blobs)
    for rec, bl in zip(records, blends):
        assert rec["iterations"] == bl.it
        assert rec["n_sources"] == len(bl.sources)
        assert_allclose(rec["logL"], bl.loss[-1], rtol=1e-5)
        assert_allclose(rec["init logL"], bl.loss[0], rtol=1e-5)
        assert rec["logL"] > rec["init logL"]
        flux = [to_numpy(s.flux).sum(axis=(-2, -1)) for s in bl.sources]
        assert_allclose(np.asarray(rec["flux"]), np.asarray(flux),
                        rtol=1e-5)


def test_stream_matches_jax_in_process(streamed, jax_blends):
    _, records, _, _ = streamed
    _, iterations, logls = jax_blends
    assert_array_equal([r["iterations"] for r in records], iterations)
    assert_allclose([r["logL"] for r in records], logls, rtol=1e-4)


def test_workers_see_no_card(streamed):
    _, _, seen, (before, after) = streamed
    assert len(seen) == 3 and len({s["pid"] for s in seen}) == 2
    for s in seen:
        assert s["CUDA_VISIBLE_DEVICES"] == ""
        assert s["device_count"] == 0
        assert s["threads"] == 1
    # the parent's environment is restored after the spawn
    assert after == before


def test_worker_error_raises(pipe, streamed):
    """A worker's error raises in the main process after every worker has
    answered, and the pool goes on serving runs."""
    pipeline, _ = pipe
    blobs = streamed[0]
    with pytest.raises(RuntimeError, match="no blend here"):
        pipeline.run(blobs[:2], _failing_build)
    records = pipeline.run(blobs[:2], tpar.build_lite_blend, max_iter=2)
    assert [r["iterations"] for r in records] == [2, 2]
