"""The control comes out not correct: the port's own lower-precision
path, its bfloat16 upload, in the program's place, every other part of
the run as it is.  On the CPU at a small size here, and on the card
(marked ``cuda``; run there with ``python -m pytest portbench/tests -m
cuda``)."""
from __future__ import annotations

import pytest

from .conftest import run_small


def _control(device):
    import torch

    rc, res = run_small("hsc_grizy.catalog_b512", device=device,
                        upload_dtype=torch.bfloat16)
    assert rc == 0
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert {"init_logl_gap", "logl_gap_q3"} <= set(over), res["checks"]


def test_control_fails_on_the_cpu():
    _control("cpu")


@pytest.mark.cuda
def test_control_fails_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control on the card")
    _control("cuda:0")
