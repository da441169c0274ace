"""The port's ten tutorial examples (``scarlet_tpu_torch.examples``) on the
CPU, each ``run(..., fast=True, device="cpu")`` on its generated stand-in
(``scarlet_tpu_torch.testing.example_data``), shrunk to 5 bands of 24-40
px with 2-4 sources (the stream and batched examples keep their blend
counts).  Each writes the PNG files the JAX script writes (names read
from the script), and its numbers are finite with the log-likelihood
improving.  ``load()`` names the absent data file (that the example
modules import no JAX: tests/test_torch_lite.py).

The whole-slice comparison: the unmodified JAX ``examples/quickstart.py``
run in process (``runpy``, ``SCARLET_TPU_FAST=1``) with ``np.load``
handing it the same stand-in, against the port's ``quickstart.run``: the
same PNG names, the same initial logL to 1e-5, the same iterations, the
fitted logL within 1e-2, and the refit with the added source starting at
the same pixel and logL and improving on its start in both.  The 1e-2: the
first adaprox steps from the spectra's least-squares start amplify
roundoff (ROADMAP Queue 3), so a 1e-7 relative change of the images moves
the port's own 12-iteration logL by up to 3.2e-3 on this stand-in, and
the two packages' float32 renders differ by more than that.
"""
import importlib
import os
import pathlib
import re
import runpy
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from scarlet_tpu_torch import examples
from scarlet_tpu_torch.examples import _common
from scarlet_tpu_torch.testing import example_data as ed

JAX_EXAMPLES = pathlib.Path(__file__).parent.parent / "examples"
SMALL = dict(shape=(5, 24, 24), n_sources=2)
# the stand-in of each example, at the tests' size
STANDINS = {
    "quickstart": lambda: ed.hsc_cosmos_35(**SMALL),
    "display_tutorial": lambda: ed.hsc_cosmos_35(**SMALL),
    "point_source": lambda: ed.psf_unmatched_sim(shape=(5, 28, 28),
                                                 n_sources=3),
    "starlet_source": lambda: ed.hsc_cosmos_35(**SMALL),
    "lsbg_wavelet_model": lambda: ed.lsbg(shape=(5, 40, 40), n_sources=3),
    "multiscale_deblending": lambda: ed.testdata_3_0(shape=(5, 28, 28),
                                                     n_sources=4),
    "stream_deblending": lambda: ed.hsc_cosmos_35(**SMALL),
    "batched_deblending": lambda: ed.hsc_cosmos_35(**SMALL),
    "multiresolution": None,        # its load() makes its data
    "hsc_hst_multires": ed.test_resampling,
}
# the number that improves over each example's fit: the multiresolution
# example's object-tree fit of 10 iterations ends below its start in the
# JAX package too (-2,666,509 -> -6,510,553); its batched fit improves
IMPROVES = {"multiresolution": "batched_logL"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_pngs(name):
    """The PNG file names the JAX script writes."""
    text = (JAX_EXAMPLES / f"{name}.py").read_text()
    return set(re.findall(r"[\"'](\w+\.png)[\"']", text))


def _check_run(name, res, out_dir):
    pngs = [f for f in res["files"] if f.endswith(".png")]
    assert set(pngs) == jax_pngs(name)
    assert len(pngs) == len(set(pngs))
    for f in pngs:
        assert (out_dir / f).stat().st_size > 0, f
    _check_panels(name, res)
    first, last = res[IMPROVES.get(name, "logL")]
    assert np.isfinite([first, last]).all()
    assert last > first
    assert set(res["seconds"]) <= {"init", "fit", "display"}


def _check_panels(name, res):
    """Every figure's RGB panels were computed, under the JAX script's PNG
    names: (H, W, 3), or 4 with a mask's alpha; only a likelihood figure
    has none."""
    assert set(res["panels"]) == jax_pngs(name)
    for f, shapes in res["panels"].items():
        assert shapes or "likelihood" in f, f
        for shape in shapes:
            assert len(shape) == 3 and shape[-1] in (3, 4), (f, shape)


def test_names_cover_the_jax_examples():
    assert sorted(examples.NAMES) == sorted(
        p.stem for p in JAX_EXAMPLES.glob("*.py"))
    for name in examples.NAMES:
        m = importlib.import_module(f"scarlet_tpu_torch.examples.{name}")
        assert callable(m.load) and callable(m.run) and callable(m.main)


@pytest.mark.parametrize("name", [n for n in examples.NAMES
                                  if n != "quickstart"])
def test_example_runs_on_its_stand_in(name, tmp_path, capsys):
    m = importlib.import_module(f"scarlet_tpu_torch.examples.{name}")
    data = m.load() if STANDINS[name] is None else STANDINS[name]()
    res = m.run(data, out_dir=tmp_path, fast=True, device="cpu")
    _check_run(name, res, tmp_path)
    assert capsys.readouterr().out


def test_no_matplotlib_no_figures(tmp_path, monkeypatch, capsys):
    """Where matplotlib is not installed (the card machine) an example
    runs every other step, its figures' panels included, draws nothing
    and says so."""
    from scarlet_tpu_torch.examples import multiscale_deblending

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = multiscale_deblending.run(STANDINS["multiscale_deblending"](),
                                    out_dir=tmp_path, fast=True,
                                    device="cpu")
    assert res["files"] == [] and not list(tmp_path.iterdir())
    _check_panels("multiscale_deblending", res)
    assert "display" in res["seconds"]
    assert "none is drawn" in capsys.readouterr().out
    first, last = res["logL"]
    assert np.isfinite([first, last]).all() and last > first


@pytest.mark.parametrize("name", [n for n in examples.NAMES
                                  if n != "multiresolution"])
def test_load_names_the_absent_file(name, tmp_path, monkeypatch):
    monkeypatch.setattr(_common, "DATA_DIR", tmp_path / "absent")
    m = importlib.import_module(f"scarlet_tpu_torch.examples.{name}")
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "absent")):
        m.load()
    with pytest.raises(FileNotFoundError):
        m.main()


def test_run_without_a_card_raises(tmp_path):
    from scarlet_tpu_torch.examples import quickstart

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.run(STANDINS["quickstart"](), out_dir=tmp_path)
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def quickstart_pair(tmp_path_factory):
    """The JAX script and the port's run on one stand-in: the script's
    globals and output directory, the port's result and directory."""
    from scarlet_tpu_torch.examples import quickstart

    data = STANDINS["quickstart"]()
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("port")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("SCARLET_TPU_FAST", "1")
        mp.setattr(np, "load", lambda *a, **k: data)
        mp.chdir(jdir)
        jglobals = runpy.run_path(str(JAX_EXAMPLES / "quickstart.py"),
                                  run_name="__main__")
    finally:
        mp.undo()
    res = quickstart.run(data, out_dir=tdir, fast=True, device="cpu")
    return jglobals, jdir, res, tdir


def test_quickstart_matches_the_jax_script(quickstart_pair):
    jg, jdir, res, tdir = quickstart_pair
    _check_run("quickstart", res, tdir)
    assert {p.name for p in jdir.glob("*.png")} == \
        {p.name for p in tdir.glob("*.png")} == jax_pngs("quickstart")
    assert (jdir / "hsc_cosmos_35.sca").exists()
    assert "hsc_cosmos_35.sca" in res["files"]
    assert res["sources"] == len(jg["sources"])
    assert res["skipped"] == list(jg["skipped"])
    assert_allclose(res["logL"][0], float(jg["blend"].log_likelihood[0]),
                    rtol=1e-5)
    assert res["iterations"] == jg["it"] == 12
    assert_allclose(res["logL"][1], float(jg["logL"]), rtol=1e-2)
    for k, flux in enumerate(res["fluxes"]):
        assert np.isfinite(flux).all()
        assert len(flux) == len(np.asarray(jg["st"].measure.flux(
            jg["sources"][k])))
    # the refit with the added source.  The JAX script's check (loss[-1] <
    # loss[0] / 20) holds whatever the refit does wherever logL > 0, as
    # here (the loss is -logL).  Held instead: the source is added at the
    # same pixel, the refit starts at the same logL within the fit's 1e-2,
    # and each package's refit improves on its own start.  Where it ends
    # is not compared: images perturbed by 1e-7 (relative) move the port's
    # refit end over 2511-2579 in 6-32 iterations and JAX's over 2378-2561
    # in 6-36 on this stand-in
    jb2 = jg["blend2"]
    jrefit = [-float(jb2.loss[0]), float(jg["logL2"])]
    assert res["added_at"] == [int(jg["py"]), int(jg["px"])]
    assert_allclose(res["refit_logL"][0], jrefit[0], rtol=1e-2)
    assert jrefit[1] > jrefit[0]
    assert res["refit_logL"][1] > res["refit_logL"][0]
    assert os.path.getsize(tdir / "quickstart_scene.png") > 0


def _eager_pair(bg_thresh):
    """Each package's lite blend of one generated scene, adaprox components
    at ``bg_thresh``, the port's SEDs and morphologies set to JAX's (the
    port's init meets JAX's to ~1e-5, tests/test_torch_lite.py), both
    then stepped three times through ``LiteBlend.grad_logL`` and each
    component's ``update``.  Returns (JAX blend, port blend, the port's
    blend at the start)."""
    import copy
    from functools import partial

    from scarlet_tpu import lite as jlite
    from scarlet_tpu_torch import lite as tlite
    from scarlet_tpu_torch.testing import generate_blend

    d = generate_blend(np.random.default_rng(5), shape=(3, 24, 24),
                       n_sources=2)
    nrms = np.sqrt(d["variance"].astype(np.float64)).mean(
        axis=(1, 2)).astype(np.float32)
    weights = (1 / d["variance"]).astype(np.float32)
    centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
               for r in d["catalog"]]
    blends = []
    for lite in (jlite, tlite):
        obs = lite.LiteObservation(
            d["images"], d["variance"], weights, d["psfs"], noise_rms=nrms,
            model_psf=lite.integrated_circular_gaussian(sigma=0.8)[None]
            .astype(np.float32),
            **({"device": "cpu"} if lite is tlite else {}))
        sources = lite.parameterize_sources(
            lite.init_all_sources_main(obs, centers, min_snr=50), obs,
            partial(lite.init_adaprox_component, bg_thresh=bg_thresh))
        blends.append(lite.LiteBlend(sources, obs))
    jb, tb = blends
    assert len(jb.components) == len(tb.components)
    for jc, tc in zip(jb.components, tb.components):
        assert jc.bbox == tc.bbox and tc.bg_thresh == bg_thresh
        tc._sed.x = torch.from_numpy(np.array(jc.sed))
        tc._morph.x = torch.from_numpy(np.array(jc.morph))
    start = tlite.LiteBlend(copy.deepcopy(tb.sources), tb.observation)
    for blend in (jb, tb):
        for it in range(3):
            grad = blend.grad_logL()
            for c in blend.components:
                c.update(it, grad)
    return jb, tb, start


def _assert_eager_matches_jax(jb, tb):
    """The losses to 5e-6 and each SED and morphology to 1e-6 of its
    largest value.  The 5e-6: a one-ulp relative perturbation of the
    port's own start morphologies moves its step-1 loss by up to 1.0e-6
    on this scene (high-SNR pixels weigh the renders' float32 roundoff),
    and the two packages' FFT renders of equal parameters already part by
    7.8e-8 at the start."""
    assert len(tb.loss) == len(jb.loss) == 3
    assert_allclose(tb.loss, jb.loss, rtol=5e-6)
    for tc, jc in zip(tb.components, jb.components):
        for t, j in ((tc.sed, jc.sed), (tc.morph, jc.morph)):
            j = np.asarray(j)
            assert_allclose(t.numpy(), j, rtol=0,
                            atol=1e-6 * np.abs(j).max())


def test_eager_update_and_fit_spectra():
    """The lite eager API the multiscale example's WaveletBlend steps
    through, against the JAX package's: from the same start, three steps
    of ``LiteBlend.grad_logL`` and each component's ``update`` (adaprox;
    ``prox_morph``'s monotonicity, positivity, centre floor and max-norm,
    as in the example) give JAX's losses, SEDs and morphologies
    (:func:`_assert_eager_matches_jax`).  They also equal the port's
    engine's three-iteration fit from the same start to 1e-6 (float32
    roundoff: the two sum in other orders).  ``fit_spectra``'s SEDs equal
    the JAX package's ``multifit_seds`` of the same morphologies, floored,
    to 1e-6."""
    import scarlet_tpu as jst
    from scarlet_tpu.lite.initialization import multifit_seds

    jb, eager, engine = _eager_pair(None)
    _assert_eager_matches_jax(jb, eager)
    engine.fit(3, e_rel=0, resize=None, reweight=False)
    assert_allclose(eager.loss, engine.loss, rtol=1e-6)
    for ce, cf in zip(eager.components, engine.components):
        for e, f in ((ce.sed, cf.sed), (ce.morph, cf.morph)):
            assert_allclose(e.numpy(), f.numpy(),
                            atol=1e-6 * float(f.abs().max()))

    ref = np.asarray(multifit_seds(
        jb.observation, [c.morph.numpy() for c in eager.components],
        [jst.Box(c.bbox.shape[1:], c.bbox.origin[1:])
         for c in eager.components]))
    eager.fit_spectra()
    for k, c in enumerate(eager.components):
        assert_allclose(c.sed.numpy(), np.maximum(ref[k], c.floor),
                        rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_eager_threshold_cut_matches_jax():
    """As :func:`test_eager_update_and_fit_spectra`'s JAX comparison, with
    the components' background threshold at 0.25: ``prox_morph`` cuts the
    pixels where every band of the model lies under 0.25 of the noise."""
    jb, tb, _ = _eager_pair(0.25)
    _assert_eager_matches_jax(jb, tb)
