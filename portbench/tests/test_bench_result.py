"""The result line against the contract: its keys, the device's, the
metrics of each mode, and the compared numbers last."""
from __future__ import annotations

import json
import re

import pytest

from portbench import spec

from .conftest import ROOT, run_small

TOP = {"correct", "attempted", "failed", "metrics", "device"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    rc, res = run_small("hsc_grizy.catalog_b512", trace=trace)
    assert rc == 0
    assert TOP <= set(res)
    assert list(res)[-1] == "checks"          # the compared numbers last
    assert DEVICE <= set(res["device"])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 16
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name
    cell = spec.load_cell("hsc_grizy.catalog_b512", root=ROOT)
    metrics = cell.per_layer if trace else cell.end_to_end
    units = {m.name: m.unit for m in metrics}
    # every metric present is the cell's, with its unit; on the CPU the
    # device-trace readers find nothing and leave theirs out
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name]
        assert isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "iters_per_blend" in res["metrics"]
    else:
        assert set(res["metrics"]) == set(units)


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "hsc_grizy.catalog_b512", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], root=ROOT)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_json_names_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in b["workloads"]:
        assert w["chips"] == 1
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").exists()
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for entry in b["workloads"] + b["configs"]:
        assert NAME.fullmatch(entry["name"])
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
