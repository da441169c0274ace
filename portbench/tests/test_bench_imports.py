"""No module that a run executes is JAX's or the JAX package's, by whole
top-level names; the yardstick (reference, generator, counting) imports
nothing of the port."""
from __future__ import annotations

import json
import subprocess
import sys
import types

from portbench import run

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "scarlet_tpu"}


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    names = _modules_after(
        "import json, sys\n"
        "from portbench.tests.conftest import run_small\n"
        "rc, res = run_small('hsc_grizy.catalog_b512')\n"
        "assert rc == 0 and res['correct'], (rc, res)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "scarlet_tpu_torch" in names       # the system under test ran
    assert not names & FORBIDDEN


def test_the_yardstick_imports_nothing_of_the_port():
    names = _modules_after(
        "import json, sys\n"
        "import numpy as np\n"
        "from portbench import check, counting, generator, spec, trace\n"
        "from portbench.reference import deblend_reference\n"
        "cell = spec.load_cell('hsc_grizy.detect_b512')\n"
        "pool = generator.make_pool(5, cell.scene, dict(cell.traffic,"
        " sources=[[3, 10, 8]]))\n"
        "deblend_reference(pool['images'][:2], pool['variance'][:2],"
        " pool['psfs'][:2], None, None, generator.model_psf(0.8),"
        " box_size=59, n_slots=16, max_iter=2, check_every=1, min_snr=50,"
        " e_rel=1e-4, device='cpu', max_peaks=16)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "scarlet_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("scarlet_tpu_torch.parallel", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.loaded_forbidden() == sorted(
        FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "scarlet_tpu.ops",
                        types.ModuleType("scarlet_tpu.ops"))
    assert "scarlet_tpu" in run.loaded_forbidden()
    assert "scarlet_tpu_torch" not in run.loaded_forbidden()
