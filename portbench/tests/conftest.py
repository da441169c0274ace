"""Shared helpers of the harness's tests: small runs of a cell on the CPU
(``run.main`` with ``device``, which skips the look for a card, and
sizes cut so that a test run holds them)."""
from __future__ import annotations

import contextlib
import io
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("hsc_grizy.catalog_b512", "rubin_euclid_10.catalog_b256",
         "hsc_grizy.detect_b512")


def small_overrides(cell):
    """A pool of 32 blends, calls of 16, 10 iterations compacted after 5,
    every record of a call compared."""
    stream = {"upload": "bulk", "compact": 5, "retry_overflow": False}
    if "detect" in cell:
        stream.update(max_peaks=16, detect_scales=3)
    return {"traffic": {"sources": [[3, 10, 8]], "blends_per_call": 16,
                        "check_blends": 16, "trace_calls": 1,
                        "stream": stream},
            "config": {"max_iter": 10, "check_every": 5}}


def run_small(cell, seed=3_000_000_019, trace=0, device="cpu", traffic=None,
              **kw):
    """(exit code, the result line as a dict or None) of a small run;
    ``traffic`` replaces entries of the small run's traffic."""
    from portbench import run

    overrides = small_overrides(cell)
    overrides["traffic"].update(traffic or {})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.1", "--trace", str(trace)], device=device,
                      root=ROOT, overrides=overrides, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)
