"""Stream against lite logL per blend on a generated set 4 (50 blends),
in both packages on the CPU: which blends part by 2% or more, and
whether the JAX package's pipelines part there too.

tests/test_testing_harness.py:166 holds the stream to the lite fit
within 2% on a small generated set; chip_smoke.py's harness phase holds
the port on the card to that limit on the same number of blends and logs
the rest of set 4.  This script is the witness for that choice: it runs
``deblend_and_measure`` with ``pipeline="stream"`` and ``"lite"`` through
``scarlet_tpu.testing`` and ``scarlet_tpu_torch.testing`` on the same
files and prints, per package, the blends past the limit with their
iterations.

    JAX_PLATFORMS=cpu python tests/stream_lite_witness.py [--out FILE]

About 9 minutes on 4 CPU threads (each package's stream and lite fits
of 50 blends at the default 100 iterations).
"""
import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

LIMIT = 0.02        # tests/test_testing_harness.py:166
SET_ID = 4


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="write the results as JSON")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch

    from scarlet_tpu import testing as jt
    from scarlet_tpu_torch import testing as tt

    torch.set_num_threads(args.threads)
    with tempfile.TemporaryDirectory() as root:
        paths = tt.bundled_blends(SET_ID, root=root)
        jpaths = jt.blendsets.generate_blend_set(SET_ID, n=len(paths),
                                                 root=root + "/jax")
        same = all(np.array_equal(np.load(a)["images"], np.load(b)["images"])
                   for a, b in zip(paths, jpaths))
        print(f"set {SET_ID}: {len(paths)} blends, the port's generator "
              f"equals JAX's: {same}", flush=True)
        runs = {}
        for who, mod, kw in (("jax", jt, {}),
                             ("torch", tt, {"device": "cpu"})):
            for pipe in ("stream", "lite"):
                t0 = time.perf_counter()
                recs = mod.deblend_and_measure(
                    set_ids=(SET_ID,), paths=paths, save=False,
                    pipeline=pipe, **kw)[SET_ID]
                runs[f"{who} {pipe}"] = [(int(r["iterations"]),
                                          float(r["logL"])) for r in recs]
                print(f"{who} {pipe}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
    out = {"same_set": same, "runs": runs}
    for who in ("jax", "torch"):
        ls = np.array([x[1] for x in runs[f"{who} stream"]])
        ll = np.array([x[1] for x in runs[f"{who} lite"]])
        rel = np.abs(ls - ll) / np.abs(ll)
        beyond = [dict(blend=int(i), rel=float(rel[i]),
                       stream=runs[f"{who} stream"][i],
                       lite=runs[f"{who} lite"][i])
                  for i in np.flatnonzero(rel >= LIMIT)]
        out[who] = dict(max_rel_first_4=float(rel[:4].max()),
                        median_rel=float(np.median(rel)), beyond=beyond)
        print(f"{who}: stream vs lite max rel logL on the first 4 blends "
              f"{rel[:4].max():.6g}, median {np.median(rel):.6g}; past "
              f"{LIMIT:.0%}: {beyond}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
