"""What a cell is, found by name: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration and traffic mix and its metrics;
everything else that belongs to one configuration, one traffic mix, one
cell or one metric sits in a file of its own under ``portbench/``:

- ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives): sizes,
  fit settings and the module of the plain reference;
- ``traffic/<traffic>.json``: the pool and the calls (``generator.py``
  reads it);
- ``cells/<cell>.json``: the limits of the numbers that decide
  ``correct`` (``limits``) and the per-blend limits that two of them
  count against (``per_blend``);
- ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's
  value, or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib
import json
import pathlib
from dataclasses import dataclass, field

HERE = pathlib.Path(__file__).resolve().parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple = ()
    layer: str = ""
    moves: str = ""

    def reader(self):
        """The metric's ``read(run)``, from ``portbench/metrics/<name>.py``."""
        return importlib.import_module(f"portbench.metrics.{self.name}").read


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    per_blend: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def scene(self):
        return tuple(int(v) for v in self.config["scene"])


def _applies(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def _metric(entry):
    keys = ("name", "unit", "better", "source", "layer", "moves")
    return Metric(workloads=tuple(entry.get("workloads", ())),
                  **{k: entry[k] for k in keys if k in entry})


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=".", bench_dir=HERE):
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with its files
    read from ``bench_dir`` (this package's directory by default)."""
    root = pathlib.Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = load_json(root / entry["file"])
    bench_dir = pathlib.Path(bench_dir)
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    cell_file = load_json(bench_dir / "cells" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=cell_file["limits"],
                per_blend=cell_file["per_blend"],
                end_to_end=[_metric(m) for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[_metric(m) for m in bench["per_layer"]
                           if _applies(m, name)])
