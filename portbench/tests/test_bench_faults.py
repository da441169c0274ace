"""A run with the timed path broken underneath comes out not correct:
for each fault that the cells can have (one chip: no exchange between
chips to leave out).  The look for a card is skipped; the rest of the run
is the benchmark's own."""
from __future__ import annotations

import numpy as np
import pytest

from .conftest import CELLS, run_small


def _stuck_step(monkeypatch):
    """A fit step that returns its state unchanged."""
    from scarlet_tpu_torch.lite import engine

    real = engine.fit_step

    def stuck(state, data, config):
        _, logL = real(state, data, config)
        return state, logL

    monkeypatch.setattr(engine, "fit_step", stuck)


def _half_batch(monkeypatch):
    """Half of each call's blends left out, their records the mean over
    the rest."""
    from scarlet_tpu_torch.parallel import stream

    real = stream.deblend_device_stream

    def half(images, variance, psfs, centers, model_psf,
             center_active=None, **kw):
        n = len(images) // 2
        cut = (lambda x: None if x is None else x[:n])
        recs, *rest = real(images[:n], variance[:n], psfs[:n], cut(centers),
                           model_psf, center_active=cut(center_active), **kw)
        mean = dict(recs[0])
        for key in ("logL", "init logL"):
            mean[key] = float(np.mean([r[key] for r in recs]))
        mean["flux"] = np.mean([r["flux"] for r in recs], axis=0)
        return [recs + [dict(mean) for _ in range(len(images) - n)],
                *rest]

    monkeypatch.setattr(stream, "deblend_device_stream", half)


def _altered_answer(monkeypatch):
    """Each record's brightest source's flux altered by 1% where the
    records are made."""
    from scarlet_tpu_torch.parallel import stream

    real = stream.stream_records

    def altered(*args, **kw):
        recs = real(*args, **kw)
        for r in recs:
            k = int(np.argmax(r["flux"].sum(axis=-1)))
            r["flux"] = r["flux"].copy()
            r["flux"][k] *= 1.01
        return recs

    monkeypatch.setattr(stream, "stream_records", altered)


def _stale_retry(monkeypatch, altered):
    """The overflow retry broken alone: its blends keep the records of the
    fit at the configured slots (the overflowed ones), marked as retried.
    ``altered`` collects the pool positions it altered."""
    from scarlet_tpu_torch.parallel import stream

    real = stream._retry_overflow

    def stale(result, *args, **kw):
        before = [dict(r) for r in result[0]]
        out = real(result, *args, **kw)
        for i, r in enumerate(out[0]):
            if r.get("overflow_retried", False):
                out[0][i] = dict(before[i], overflow=True,
                                 overflow_retried=True)
                altered.append(i)
        return out

    monkeypatch.setattr(stream, "_retry_overflow", stale)


# 2 blends of 3-4 sources and 6 of 16 in every flip: a call of 16 blends
# holds 12 crowded ones, whose init overflows 16 slots, more than the
# count of off blends that a cell allows; the overflow retry on, as a
# crowded cell would run it
CROWDED = {"sources": [[3, 4, 2], [16, 16, 6]],
           "stream": {"upload": "bulk", "compact": 5,
                      "retry_overflow": True}}

FAULTS = {"stuck_step": _stuck_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    rc, res = run_small(cell)
    assert rc == 0 and res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rc, res = run_small("hsc_grizy.catalog_b512")
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def _compared(monkeypatch):
    """The numbers that the run compared, as ``check.numbers`` gave them."""
    from portbench import check

    seen = []
    real = check.numbers

    def keep(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(check, "numbers", keep)
    return seen


@pytest.mark.parametrize("retry", [True, False])
def test_overflowed_blends_are_compared(retry, monkeypatch):
    # a sound run whose crowded blend overflows 16 slots: its records are
    # compared, refitted by the retry or fitted at the slots they fill
    seen = _compared(monkeypatch)
    traffic = dict(CROWDED, stream=dict(CROWDED["stream"],
                                        retry_overflow=retry))
    rc, res = run_small("hsc_grizy.catalog_b512", traffic=traffic)
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert seen[-1]["overflowed"] > 0
    assert (seen[-1]["retried"] > 0) is retry


def test_stale_retry_is_not_correct(monkeypatch):
    altered = []
    _stale_retry(monkeypatch, altered)
    rc, res = run_small("hsc_grizy.catalog_b512", traffic=CROWDED)
    assert altered, "no call took the overflow retry"
    assert rc == 0
    assert res["correct"] is False, res["checks"]
