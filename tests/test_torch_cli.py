"""``python -m scarlet_tpu_torch deblend`` on the CPU: npz files in, JSON
records out, through the port's device stream; its loader against the
JAX package's, exactly.

Inputs: five npz files written as tests/test_cli.py:17-44 writes them
(generated blends, ``default_rng(7)``): three complete, one without a
variance plane, one without a catalog.  The command runs in process
through ``main([...])``; one subprocess checks ``--help``.

The records are held to the JAX package's command (``scarlet_tpu.__main__
.main``, in process on the CPU) on the same files, and with ``--redetect
1 --reweight`` on copies whose catalogs lack their last source where
they are not the longest (the records sized from the final catalog; the
longest keeps the catalogs' width, so each pass compiles one layout in
the JAX package): iterations, source and component
counts equal, init logL to rtol 1e-4, logL to rtol 1e-4
(tests/test_pipeline.py:49-50) or within 3x the JAX package's own move
when the images are multiplied by 3 and the variance by 9.  That
rescaling leaves every logL unchanged in exact arithmetic and changes
every rounding; the first blend's fit starts from the spectra's
least-squares optimum, where the gradient is roundoff that adaprox's
third step turns into a full step (ROADMAP Queue 3), so its logL after
10 iterations moves by 4.6e-4 under the rescaling in the JAX package
(1e-3 in the port), and the two packages part by 5.1e-4 on it.

The records are also held to ``deblend_device_stream`` called directly
on the same stacks: iterations and source counts equal, logL to rtol 1e-5,
fluxes, SNRs and centroids to 1e-4 of each record's largest value.  Not
bit for bit: torch's CPU reductions and MKL's FFTs split their work over
the threads they get, which vary with the machine's load, and two runs of
one stream in one process were seen to part by 3.6e-6 in a logL after 10
iterations (never with the machine idle).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import scarlet_tpu.__main__ as jcli
import scarlet_tpu_torch.__main__ as tcli
from scarlet_tpu_torch import lite, parallel
from scarlet_tpu_torch.testing import generate_blend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the record keys of the JAX package's CLI (scarlet_tpu/__main__.py:
# 195-221)
RECORD_KEYS = {"file", "n_sources", "n_components", "iterations", "logL",
               "init_logL", "flux", "centroid", "moments", "snr"}
ARGS = ["--max-iter", "10", "--chunk", "4"]
# the runs held to the JAX package's command: input directory, flags
# beyond ARGS
JAX_RUNS = {"catalog": ("blends", ()),
            "redetect": ("redetect", ("--redetect", "1", "--reweight"))}
RESCALE, WITNESS_FACTOR = 3.0, 3.0


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
def blend_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("blends")
    rng = np.random.default_rng(7)
    paths = []
    for i in range(3):
        b = generate_blend(rng)
        path = root / f"blend_{i}.npz"
        np.savez_compressed(path, images=b["images"],
                            variance=b["variance"], psfs=b["psfs"],
                            catalog=b["catalog"])
        paths.append(str(path))
    b = generate_blend(rng)
    path = root / "blend_novar.npz"
    np.savez_compressed(path, images=b["images"], psfs=b["psfs"],
                        catalog=b["catalog"])
    paths.append(str(path))
    b = generate_blend(rng)
    path = root / "blend_nocat.npz"
    np.savez_compressed(path, images=b["images"], variance=b["variance"],
                        psfs=b["psfs"])
    paths.append(str(path))
    return root, sorted(paths)


def _copy(paths, dst, scale=1.0, drop_last=False):
    """The files in ``dst``: images times ``scale``, variance times its
    square, and with ``drop_last`` each catalog shorter than the longest
    without its last row."""
    datas = [dict(np.load(p, allow_pickle=True)) for p in paths]
    width = max(len(z["catalog"]) for z in datas if "catalog" in z)
    for p, z in zip(paths, datas):
        z["images"] = (z["images"] * np.float32(scale)).astype(np.float32)
        if "variance" in z:
            z["variance"] = (z["variance"] * np.float32(scale ** 2)
                             ).astype(np.float32)
        if drop_last and "catalog" in z and len(z["catalog"]) < width:
            z["catalog"] = z["catalog"][:-1]
        np.savez_compressed(dst / os.path.basename(p), **z)
    return dst


@pytest.fixture(scope="module")
def inputs(blend_files, tmp_path_factory):
    """Input directories by name: the files, the redetect copies, and
    both rescaled."""
    root, paths = blend_files
    red = _copy(paths, tmp_path_factory.mktemp("redetect"), drop_last=True)
    dirs = {"blends": root, "redetect": red}
    for name, src in list(dirs.items()):
        dirs[f"{name} x3"] = _copy(sorted(src.glob("*.npz")),
                                   tmp_path_factory.mktemp("rescaled"),
                                   scale=RESCALE)
    return dirs


def _deblend(root, out, *extra):
    rc = tcli.main(["deblend", str(root / "*.npz"), "--out", str(out),
                    "--cpu", *ARGS, *extra])
    assert rc == 0
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    """The command's output for each of ``JAX_RUNS``, and with ``--detect
    host`` and ``--detect device`` (3 iterations: only their catalogs are
    compared)."""
    tmp = tmp_path_factory.mktemp("out")
    runs = dict(JAX_RUNS,
                host=("blends", ("--detect", "host", "--max-iter", "3")),
                device=("blends", ("--detect", "device", "--max-iter", "3")))
    return {mode: _deblend(inputs[src], tmp / f"{mode}.json", *extra)
            for mode, (src, extra) in runs.items()}


@pytest.fixture(scope="module")
def jax_results(inputs, tmp_path_factory):
    """The JAX package's command for each of ``JAX_RUNS``, on its inputs
    and on their rescaled copies."""
    tmp = tmp_path_factory.mktemp("jax_out")
    out = {}
    for mode, (src, extra) in JAX_RUNS.items():
        for name, where in ((mode, src), (f"{mode} x3", f"{src} x3")):
            path = tmp / f"{name}.json"
            assert jcli.main(["deblend", str(inputs[where] / "*.npz"),
                              "--out", str(path), "--cpu", *ARGS,
                              *extra]) == 0
            with open(path) as f:
                out[name] = json.load(f)
    return out


@pytest.mark.parametrize("detect", [None, "host", "device"])
def test_load_blend_matches_jax(blend_files, detect):
    _, paths = blend_files
    for path in paths:
        ours = tcli._load_blend(path, detect=detect)
        theirs = jcli._load_blend(path, detect=detect)
        for a, b in zip(ours[:3], theirs[:3]):
            assert a.dtype == b.dtype
            assert_array_equal(a, b)
        assert ours[3] == theirs[3]


def test_records_match_the_stream(blend_files, results):
    root, paths = blend_files
    res = results["catalog"]
    assert res["n_blends"] == len(paths)
    recs = res["records"]
    assert [r["file"] for r in recs] == paths
    assert all(set(r) == RECORD_KEYS for r in recs)

    blends = [tcli._load_blend(p) for p in paths]
    K = max(len(b[3]) for b in blends)
    carr = np.zeros((len(blends), K, 2), np.int32)
    cact = np.zeros((len(blends), K), bool)
    for i, b in enumerate(blends):
        carr[i, :len(b[3])] = b[3]
        cact[i, :len(b[3])] = True
    C, H, W = blends[0][0].shape
    cap = max(H, W) + 1
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    direct = parallel.deblend_device_stream(
        *(np.stack([b[j] for b in blends]) for j in range(3)), carr,
        model_psf, center_active=cact, box_size=cap - (cap % 2 == 0),
        n_slots=2 * K, max_iter=10, e_rel=1e-4, min_snr=50, check_every=25,
        chunk=4, compact=50, device="cpu")[0]
    for rec, raw, b in zip(recs, direct, blends):
        k = len(b[3])
        assert rec["n_sources"] == k
        assert rec["n_components"] == int(raw["n_components"])
        assert rec["iterations"] == int(raw["iterations"])
        assert_allclose(rec["logL"], raw["logL"], rtol=1e-5)
        assert_allclose(rec["init_logL"], raw["init logL"], rtol=1e-5)
        for key in ("flux", "snr", "centroid"):
            want = np.asarray(raw[key], float)[:k]
            assert_allclose(np.asarray(rec[key], float), want, rtol=0,
                            atol=1e-4 * np.abs(want).max())
        assert rec["logL"] > rec["init_logL"]
        assert np.asarray(rec["flux"]).shape == (k, C)

    # centroids recover the catalog positions (tests/test_cli.py:72-77)
    data = np.load(recs[0]["file"], allow_pickle=True)
    truth = np.stack([data["catalog"]["y"], data["catalog"]["x"]], axis=1)
    err = np.linalg.norm(np.asarray(recs[0]["centroid"]) - truth, axis=1)
    assert np.median(err) < 2.0, err


@pytest.mark.parametrize("mode", sorted(JAX_RUNS))
def test_records_match_jax_command(inputs, results, jax_results, mode):
    ours, theirs = results[mode], jax_results[mode]
    moved = jax_results[f"{mode} x3"]["records"]
    assert ours["n_blends"] == theirs["n_blends"]
    counts = ("n_sources", "n_components", "iterations")
    for a, b, c in zip(ours["records"], theirs["records"], moved):
        assert set(a) == set(b) == RECORD_KEYS
        assert a["file"] == b["file"]
        for key in counts:
            assert a[key] == b[key] == c[key], key
        assert_allclose(a["init_logL"], b["init_logL"], rtol=1e-4)
        assert abs(a["logL"] - b["logL"]) <= max(
            1e-4 * abs(b["logL"]),
            WITNESS_FACTOR * abs(b["logL"] - c["logL"])), a["file"]
        for key in ("flux", "centroid", "moments", "snr"):
            assert len(a[key]) == len(b[key]) == a["n_sources"], key
    if mode == "redetect":
        # the residuals give back sources the catalogs lack, and each
        # record is sized from the final catalog
        given = [len(tcli._load_blend(r["file"])[3])
                 for r in ours["records"]]
        found = [r["n_sources"] for r in ours["records"]]
        assert all(f >= g for f, g in zip(found, given))
        assert sum(found) > sum(given)


def test_device_detection_matches_host(results):
    """``--detect device`` (``parallel.detect_peaks_device``) finds the
    host detection's peak sets; only the catalog order differs, so the
    sorted centroids agree (tests/test_cli.py:98-110)."""
    for rh, rd in zip(results["host"]["records"],
                      results["device"]["records"]):
        assert rh["file"] == rd["file"]
        assert rh["n_sources"] == rd["n_sources"]
        assert np.isfinite(rd["logL"])
        ch = np.asarray(rh["centroid"], float)
        cd = np.asarray(rd["centroid"], float)
        ch = ch[np.lexsort(ch.T)]
        cd = cd[np.lexsort(cd.T)]
        assert_allclose(cd, ch, atol=0.1)


def test_help_names_the_command():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    result = subprocess.run(
        [sys.executable, "-m", "scarlet_tpu_torch", "--help"],
        capture_output=True, text=True, timeout=120, env=env)
    assert result.returncode == 0
    assert "deblend" in result.stdout


def test_no_card_without_cpu_fails_and_writes_nothing(blend_files, tmp_path,
                                                      capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command runs on it")
    root, _ = blend_files
    out = tmp_path / "results.json"
    rc = tcli.main(["deblend", str(root / "*.npz"), "--out", str(out),
                    *ARGS])
    assert rc != 0
    assert not out.exists()
    assert "no CUDA device" in capsys.readouterr().err
