"""The port's regression harness (``scarlet_tpu_torch.testing``: store,
metrics, the lite, stream and main pipelines, plots, the CLI) and
``utils.fits`` against the JAX package's, on the CPU.

Inputs: two blends of a generated set 4 (``generate_blend_set(4, n=2)``)
in a temporary root.  Tolerances: the lite and stream pipelines at 10
iterations, iterations equal and logL to rtol 1e-4 (the tolerance of
tests/test_pipeline.py:49-50), the same truth-matched sources.  The main
pipeline (the object tree) on one blend: the model PSF's variance, the
source count and the skipped sources equal, the init logL to 1e-5, and
the final logL after 3 iterations held to the CPU's own spread: the
init solves the spectra to their joint least-squares optimum, whose
gradient is roundoff that adaprox's first steps turn into full steps
(ROADMAP Queue 3), so the port is held to JAX within 1e-4 or 3x the
largest distance between the port's own runs on the images and on the
images times (1 + 1e-7 N(0, 1)), seed 0 (as chip_smoke.py holds
the object tree's card to the CPU).
"""
import json
import pathlib

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from scarlet_tpu import testing as jt
from scarlet_tpu.testing import measure as jmeasure
from scarlet_tpu.utils import fits as jfits
from scarlet_tpu_torch import testing as tt
from scarlet_tpu_torch.testing import measure as tmeasure
from scarlet_tpu_torch.testing import __main__ as tmain
from scarlet_tpu_torch.utils import fits as tfits

MAX_ITER = 10
MAIN_ITER = 3
PERTURB, WITNESS_SEEDS, WITNESS_FACTOR = 1e-7, (0,), 3.0


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
def small_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("regression")
    return root, tt.generate_blend_set(set_id=4, n=2, root=root)


@pytest.fixture(scope="module")
def pipelines(small_set):
    """Both packages' records of the lite and stream pipelines."""
    _, paths = small_set
    out = {}
    for pipe in ("lite", "stream"):
        kw = dict(set_ids=(91,), paths=paths, save=False, pipeline=pipe,
                  max_iter=MAX_ITER)
        out[pipe] = (tt.deblend_and_measure(device="cpu", **kw)[91],
                     jt.deblend_and_measure(**kw)[91])
    return out


def test_store_round_trips_between_packages(tmp_path):
    recs = [{"logL": -1.5, "iterations": 7, "sources": [{"r diff": 0.1}]}]
    tt.save_records(recs, 4, branch="b", root=tmp_path / "t")
    assert jt.load_records(4, branch="b", root=tmp_path / "t")[-1][
        "records"] == recs
    jt.save_records(recs, 5, branch="b", root=tmp_path / "j")
    tt.save_records(recs, 5, branch="b", root=tmp_path / "j")
    runs = tt.load_records(5, branch="b", root=tmp_path / "j")
    assert [r["records"] for r in runs] == [recs, recs]
    assert tt.load_records(6, branch="b", root=tmp_path / "t") == []
    res = tt.save_residuals(np.ones((2, 3, 3)), np.zeros((2, 3, 3)), 4, 0,
                            branch="b", root=tmp_path / "t")
    assert res == tmp_path / "t" / "b" / "residuals" / "set4_blend0.npz"


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    truth = rng.uniform(0, 40, (6, 2))
    det = np.concatenate([truth[:4] + rng.normal(0, 1, (4, 2)),
                          rng.uniform(0, 40, (3, 2))])
    for radius in (1.0, 3.0):
        assert tmeasure.detection_metrics(truth, det, radius) == \
            jmeasure.detection_metrics(truth, det, radius)
    a, b = rng.uniform(-1, 100, 5), rng.uniform(0, 100, 5)
    assert_array_equal(tt.mag_diff(a, b), jt.mag_diff(a, b))
    assert tt.measurements == jt.measurements

    d = tt.generate_blend(np.random.default_rng(5), n_sources=4)
    cat = d["catalog"]
    k = len(cat)
    fluxes = rng.uniform(0.1, 50, (k, 5))
    cents = np.stack([cat["y"], cat["x"]], 1) + rng.normal(0, 0.5, (k, 2))
    moms = np.abs(rng.normal(2, 0.5, (k, 3)))
    args = (fluxes, cat, list("grizy"))
    kw = dict(centroids=cents, moments=moms, psf_var=0.5)
    assert tmeasure.measure_flux_records(*args, **kw) == \
        jmeasure.measure_flux_records(*args, **kw)
    assert tmeasure.measure_flux_records(*args) == \
        jmeasure.measure_flux_records(*args)


@pytest.mark.parametrize("pipe", ["lite", "stream"])
def test_batched_pipelines_match_jax(pipelines, pipe):
    ours, theirs = pipelines[pipe]
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a["blend"] == b["blend"]
        assert a["n_sources"] == b["n_sources"]
        assert a["iterations"] == b["iterations"]
        assert_allclose(a["logL"], b["logL"], rtol=1e-4)
        assert_allclose(a["init logL"], b["init logL"], rtol=1e-4)
        assert a["logL"] > a["init logL"]
        assert [sorted(s) for s in a["sources"]] == \
            [sorted(s) for s in b["sources"]]
        assert any("r diff" in s for s in a["sources"])


def test_stream_matches_lite_pipeline(pipelines):
    """tests/test_testing_harness.py:166 on the port."""
    ll = np.asarray([r["logL"] for r in pipelines["lite"][0]])
    ls = np.asarray([r["logL"] for r in pipelines["stream"][0]])
    assert np.all(np.abs(ls - ll) < 0.02 * np.abs(ll))


def test_main_pipeline_matches_jax(small_set):
    _, paths = small_set
    data = dict(np.load(paths[0], allow_pickle=True))
    ours = tt.deblend_and_measure(set_ids=(91,), paths=paths[:1],
                                  save=False, pipeline="main",
                                  max_iter=MAIN_ITER, device="cpu")[91][0]
    theirs = jt.deblend_and_measure(set_ids=(91,), paths=paths[:1],
                                    save=False, pipeline="main",
                                    max_iter=MAIN_ITER)[91][0]
    for key in ("model_psf_var", "n_sources", "skipped", "iterations",
                "blend"):
        assert ours[key] == theirs[key], key
    assert_allclose(ours["init logL"], theirs["init logL"], rtol=1e-5)
    assert [sorted(s) for s in ours["sources"]] == \
        [sorted(s) for s in theirs["sources"]]

    runs = [ours["logL"]]
    for seed in WITNESS_SEEDS:
        noise = np.random.default_rng(seed).standard_normal(
            data["images"].shape)
        moved = dict(data, images=(data["images"] * (1 + PERTURB * noise))
                     .astype(np.float32))
        runs.append(tt.deblend(moved, max_iter=MAIN_ITER,
                               device="cpu")[2]["logL"])
    spread = max(abs(a - b) for a in runs for b in runs)
    assert abs(ours["logL"] - theirs["logL"]) <= max(
        1e-4 * abs(theirs["logL"]), WITNESS_FACTOR * spread)


def test_detection_quality_device_matches_host(small_set):
    _, paths = small_set
    dev = tt.api.detection_quality(set_ids=(4,), paths=paths, device="cpu")
    host = tt.api.detection_quality(set_ids=(4,), paths=paths, host=True)
    jax = jt.api.detection_quality(set_ids=(4,), paths=paths, device=True)
    assert dev[4]["path"] == "device" and host[4]["path"] == "host"
    assert dev[4]["blends"] == host[4]["blends"] == jax[4]["blends"]


def test_dashboard_renders(pipelines, tmp_path):
    tt.save_records(pipelines["lite"][0], 91, branch="test", root=tmp_path)
    written = tt.render_dashboard(set_ids=(91,), root=tmp_path,
                                  detection={4: {"completeness": 0.8,
                                                 "false_rate": 0.1,
                                                 "blends": [
                                                     {"completeness": 1.0},
                                                     {"completeness": 0.6}]}})
    names = {p.name for p in written}
    assert {"index.html", "set91.png", "detection.png"} <= names
    assert all(p.exists() for p in written)


def test_cli_baseline_and_device(tmp_path, monkeypatch, capsys):
    assert tmain.BASELINE_DIR.resolve() == (
        pathlib.Path(tt.__file__).parent / "baselines").resolve()
    assert "scarlet_tpu_torch" in tmain.BASELINE_DIR.resolve().parts
    monkeypatch.setattr(tmain, "BASELINE_DIR", tmp_path / "baselines")
    assert tmain.main(["--sets", "91", "--no-save", "--cpu", "--baseline",
                       "--root", str(tmp_path / "store")]) == 0
    runs = json.loads((tmp_path / "baselines" / "set91.json").read_text())
    assert runs[-1]["records"] == []
    if torch.cuda.is_available():
        return
    # no card and no --cpu: a message, a non-zero exit, no records
    capsys.readouterr()
    assert tmain.main(["--sets", "4", "--root", str(tmp_path / "none")]) \
        != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()


def _card(key, value):
    if isinstance(value, str):
        text = f"{key:<8}= '{value}'"
    elif isinstance(value, bool):
        text = f"{key:<8}= {'T' if value else 'F':>20}"
    else:
        text = f"{key:<8}= {value!r:>20}"
    return text.ljust(80).encode("ascii")


def _hdu(cards, data):
    head = b"".join(_card(k, v) for k, v in cards) + b"END".ljust(80)
    head += b" " * (-len(head) % 2880)
    body = data.tobytes()
    return head + body + b"\0" * (-len(body) % 2880)


def test_read_fits_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    ints = rng.integers(-300, 300, (6, 5)).astype(">i2")
    floats = rng.normal(size=(2, 4, 3)).astype(">f4")
    raw = _hdu([("SIMPLE", True), ("BITPIX", 16), ("NAXIS", 2),
                ("NAXIS1", 5), ("NAXIS2", 6), ("BSCALE", 0.5),
                ("BZERO", 10.0), ("CRPIX1", 3.0), ("CRPIX2", 2.5),
                ("CRVAL1", 150.1), ("CRVAL2", 2.2), ("CD1_1", -1.5e-5),
                ("CD1_2", 2e-6), ("CD2_1", 1e-6), ("CD2_2", 1.5e-5),
                ("CTYPE1", "RA---TAN"), ("CTYPE2", "DEC--TAN")], ints)
    raw += _hdu([("XTENSION", "IMAGE"), ("BITPIX", -32), ("NAXIS", 3),
                 ("NAXIS1", 3), ("NAXIS2", 4), ("NAXIS3", 2),
                 ("CRPIX1", 1.0), ("CRPIX2", 2.0), ("CDELT1", -2e-5),
                 ("CDELT2", 2e-5), ("PC1_2", 0.1)], floats)
    path = tmp_path / "small.fits"
    path.write_bytes(raw)
    for hdu in (0, 1):
        data, header, wcs = tfits.read_fits(path, hdu=hdu)
        jdata, jheader, jwcs = jfits.read_fits(path, hdu=hdu)
        assert_array_equal(data, jdata)
        assert data.dtype == jdata.dtype
        assert header == jheader
        assert wcs.array_shape == jwcs.array_shape
        for name in ("crpix", "crval", "pc", "cdelt"):
            assert_array_equal(getattr(wcs.wcs, name),
                               getattr(jwcs.wcs, name))
        assert wcs.wcs.ctype == jwcs.wcs.ctype
        pix = np.array([[0.0, 0.0], [2.5, 1.0]])
        assert_array_equal(wcs.pixel_to_world_values(pix),
                           jwcs.pixel_to_world_values(pix))
    assert_array_equal(tfits.read_fits(path)[0], ints * 0.5 + 10.0)
