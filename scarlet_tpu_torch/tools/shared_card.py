"""T1's K1 / full check, on a quiet card and on a shared one.

``chip_smoke.py`` fails unless K1's cost per pass over T1's ``full`` (K1's
pass, forced) lies in 0.8-1.25.  This tool says whether another process
on the card can move either reading: on a quiet card, then beside a
second process that multiplies float32 (8192, 8192) matrices on the same
card for as long as the measurement lasts, it times

- :func:`mono_pass_attrib.k1_over_full`: K1 and full in one queue per
  round, least of ``--rounds`` rounds, the ratio that ``chip_smoke.py``
  holds;
- ``full``'s slope as the attribution tool times it
  (:func:`mono_pass_attrib.attribute`, counts 8-352, calls of up to
  3 ms), and K1's in-turns slope over it.

Run with a CUDA device (exits non-zero without one)::

    python -m scarlet_tpu_torch.tools.shared_card [--rounds 31]
        [--repeats 2]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from . import mono_pass_attrib as tool

# the second process: products of (8192, 8192) float32 matrices on the
# card until it is killed; it says "ready" once the first has run
LOAD = """
import torch
x = torch.randn(8192, 8192, device="cuda")
y = x @ x
torch.cuda.synchronize()
print("ready", flush=True)
while True:
    y = x @ x
    torch.cuda.synchronize()
"""


def readings(device, rounds):
    """K1 / full in turns and against the tool's full, with the slopes."""
    turns = tool.k1_over_full(device, rounds)
    full = tool.attribute(device, variants=["full"])["variants"]["full"]
    k1 = turns["k1"]["us_per_pass_per_blend"]
    return {
        "k1_us": k1,
        "full_in_turns_us": turns["full"]["us_per_pass_per_blend"],
        "k1_over_full": turns["over_full"],
        "by_round": [min(turns["over_full_by_round"]),
                     max(turns["over_full_by_round"])],
        "tool_full_us": full["us_per_pass_per_blend"],
        "k1_over_tool_full": k1 / full["us_per_pass_per_blend"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=31)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shared_card: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(device),
           "quiet": [readings(device, args.rounds)
                     for _ in range(args.repeats)]}
    load = subprocess.Popen([sys.executable, "-c", LOAD],
                            stdout=subprocess.PIPE, text=True)
    try:
        if load.stdout.readline().strip() != "ready":
            raise RuntimeError("the second process did not start")
        out["shared"] = [readings(device, args.rounds)
                         for _ in range(args.repeats)]
    finally:
        load.kill()
        load.wait()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
