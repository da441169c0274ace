"""The harness finds a configuration, a traffic mix, a cell's limits and
a metric's reader by name; a new traffic mix is a new file and a new
entry, and no file that is there changes."""
from __future__ import annotations

import json
import shutil

from portbench import generator, spec

from .conftest import ROOT


def test_finds_every_cell_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], root=ROOT)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) >= {"failed", "init_logl_gap"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(m.reader())


def test_a_new_traffic_mix_is_a_new_file(tmp_path):
    # a copy of the benchmark's files in a temporary checkout, plus one
    # throwaway traffic mix and its cell: nothing that was there changes
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    traffic = json.loads(
        (root / "portbench/traffic/catalog_b512.json").read_text())
    traffic.update(name="crowded_b64", blends_per_call=64,
                   sources=[[12, 19, 16]])
    (root / "portbench/traffic/crowded_b64.json").write_text(
        json.dumps(traffic))
    (root / "portbench/cells/hsc_grizy.crowded_b64.json").write_text(
        json.dumps({"limits": {"failed": 0},
                    "per_blend": {"logl": 1e-5, "flux": 1e-4}}))
    bench["workloads"].append({"name": "hsc_grizy.crowded_b64",
                               "config": "hsc_grizy",
                               "traffic": "crowded_b64", "chips": 1,
                               "why": "crowded scenes"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("hsc_grizy.crowded_b64", root=root,
                          bench_dir=root / "portbench")
    assert cell.traffic["blends_per_call"] == 64
    assert cell.limits == {"failed": 0}
    assert cell.per_blend == {"logl": 1e-5, "flux": 1e-4}
    pool = generator.make_pool(1, cell.scene, cell.traffic)
    assert pool["images"].shape[0] == 64
    assert pool["n_sources"].min() == 12 and pool["n_sources"].max() == 19
    for p, data in before.items():
        assert p.read_bytes() == data, p
