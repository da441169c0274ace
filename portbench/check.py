"""Whether what the timed path produced is correct: the window's records,
a sample drawn from the seed and every kind named below, against the
plain reference (``configs/<config>.json`` names its module) run on the
same generated inputs once the window has closed.

The compared records: a reservoir of ``check_blends`` over all records of
the window, the first record with the most iterations, and a reservoir of
up to ``OVERFLOWED`` records of blends whose init overflowed the slots
(refitted by the overflow retry where the traffic turns it on, fitted at
the slots they fill where it does not).  The numbers, each against
a limit from ``cells/<cell>.json``:

- ``failed``: blends of the window whose call raised or whose record is
  not finite (log-likelihoods and fluxes);
- ``init_logl_gap``: the widest relative gap of a compared blend's first
  log-likelihood (the init's model: catalog or detection, seeds, slots,
  the first scene and convolution);
- ``logl_gap_q3``, ``flux_gap_q3``: the third quartile, over the compared
  blends, of the relative gap of a blend's last log-likelihood (the fit)
  and of its summed absolute flux difference over its reference's summed
  absolute flux (the records);
- ``logl_over``, ``flux_over``: how many compared blends have a gap above
  the cell's per-blend limit (``per_blend`` in the cell's file).  A
  count's limit of 0 fails any blend over it; where the fit of a few
  blends in a hundred is ill-conditioned (a 1e-7 change of the images
  moves the reference's own last log-likelihood of such a blend by up to
  ~1e-1), the limit is the allowance that sound runs need.

The widest gaps (``logl_gap_max``, ``flux_gap_max``), the blends whose
active component count differs (``components_gap``) and the retried and
overflowed records compared (``retried``, ``overflowed``) are printed
beside them.  A number without a limit in the cell's file is printed and not held.
"""
from __future__ import annotations

import importlib
import math

import numpy as np

NUMBERS = ("failed", "init_logl_gap", "logl_gap_q3", "flux_gap_q3",
           "logl_over", "flux_over", "logl_gap_max", "flux_gap_max",
           "components_gap", "retried", "overflowed")

# the records of blends that overflowed the slots that a run compares, at
# most
OVERFLOWED = 16


def finite_record(rec):
    return (math.isfinite(rec["logL"]) and math.isfinite(rec["init logL"])
            and bool(np.all(np.isfinite(rec["flux"]))))


def kept_fields(rec):
    """The fields of a record that the comparison reads, copied."""
    return {"iterations": int(rec["iterations"]),
            "logL": float(rec["logL"]),
            "init logL": float(rec["init logL"]),
            "n_components": int(rec["n_components"]),
            "flux": np.array(rec["flux"], dtype=np.float64),
            "retried": bool(rec.get("overflow_retried", False)),
            "overflow": bool(rec.get("overflow", False))}


class Sample:
    """The compared records, drawn from the seed: a reservoir of ``size``
    (pool index, record) pairs over all records in the order they come,
    the first record with the most iterations ("the longest"), and a
    reservoir of ``OVERFLOWED`` records of blends that overflowed the
    slots."""

    def __init__(self, seed, size):
        self.rng = np.random.default_rng([int(seed), 7])
        self.size = int(size)
        self.seen = 0
        self.reservoir = []
        self.longest = None
        self.overflowed = []
        self.n_overflowed = 0

    @staticmethod
    def _keep(pool, size, seen, rng, item):
        if len(pool) < size:
            pool.append(item)
        else:
            j = int(rng.integers(seen))
            if j < size:
                pool[j] = item

    def offer(self, index, rec):
        self.seen += 1
        self._keep(self.reservoir, self.size, self.seen, self.rng,
                   (index, kept_fields(rec)))
        if self.longest is None \
                or rec["iterations"] > self.longest[1]["iterations"]:
            self.longest = (index, kept_fields(rec))
        if rec.get("overflow", False):
            self.n_overflowed += 1
            self._keep(self.overflowed, OVERFLOWED, self.n_overflowed,
                       self.rng, (index, kept_fields(rec)))

    def pairs(self):
        extra = [self.longest] if self.longest is not None else []
        return self.reservoir + extra + self.overflowed


def reference_records(cell, pool, indices, model_psf, device):
    """The plain reference's records of the pool's blends ``indices``."""
    ref = importlib.import_module(cell.config["reference"])
    idx = np.asarray(indices)
    cfg, tr = cell.config, cell.traffic
    catalog = bool(tr["catalog"])
    stream_kw = tr.get("stream", {})
    recs = ref.deblend_reference(
        pool["images"][idx], pool["variance"][idx], pool["psfs"][idx],
        pool["centers"][idx] if catalog else None,
        pool["active"][idx] if catalog else None, model_psf,
        box_size=cfg["box_size"], n_slots=cfg["n_slots"],
        max_iter=cfg["max_iter"], check_every=cfg["check_every"],
        min_snr=cfg["min_snr"], e_rel=cfg["e_rel"], device=device,
        max_peaks=stream_kw.get("max_peaks"),
        detect_scales=stream_kw.get("detect_scales", 3),
        retry_overflow=bool(stream_kw.get("retry_overflow", False)))
    return {int(i): kept_fields(r) for i, r in zip(idx, recs)}


def _rel(a, b):
    d = abs(a - b) / max(abs(b), 1e-30)
    return d if math.isfinite(d) else math.inf


def numbers(pairs, ref, failed, per_blend):
    """The numbers of the compared ``pairs`` against ``ref``, the counts
    over ``per_blend`` ({"logl": x, "flux": y}) among them."""
    init_gap, logl, flux, comp, retried, over = 0.0, [], [], 0, 0, 0
    for index, rec in pairs:
        r = ref[index]
        init_gap = max(init_gap, _rel(rec["init logL"], r["init logL"]))
        logl.append(_rel(rec["logL"], r["logL"]))
        den = float(np.sum(np.abs(r["flux"])))
        num = float(np.sum(np.abs(rec["flux"] - r["flux"])))
        gap = num / max(den, 1e-30)
        flux.append(gap if math.isfinite(gap) else math.inf)
        comp += int(rec["n_components"] != r["n_components"])
        retried += int(rec["retried"])
        over += int(rec["overflow"])
    return {"failed": int(failed), "init_logl_gap": init_gap,
            "logl_gap_q3": _q3(logl), "flux_gap_q3": _q3(flux),
            "logl_gap_max": max(logl, default=0.0),
            "flux_gap_max": max(flux, default=0.0),
            "components_gap": comp, "retried": retried, "overflowed": over,
            "logl_over": sum(g > per_blend["logl"] for g in logl),
            "flux_over": sum(g > per_blend["flux"] for g in flux)}


def widest(pairs, ref, top=8):
    """The ``top`` widest per-blend gaps of the last log-likelihood and of
    the fluxes, widest first."""
    logl, flux = [], []
    for index, rec in pairs:
        r = ref[index]
        logl.append(_rel(rec["logL"], r["logL"]))
        den = float(np.sum(np.abs(r["flux"])))
        flux.append(float(np.sum(np.abs(rec["flux"] - r["flux"])))
                    / max(den, 1e-30))
    return {"logl": sorted(logl, reverse=True)[:top],
            "flux": sorted(flux, reverse=True)[:top]}


def _q3(values):
    """The third quartile (numpy's linear rule); inf when any value is."""
    if not values:
        return 0.0
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return float(np.percentile(values, 75))


def judge(values, limits):
    """(correct, checks): each number that has a limit, beside it; correct
    when none exceeds its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]}
              for k in NUMBERS if k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
