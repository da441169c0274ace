"""Command-line entry: batch deblending through the device stream.

    python -m scarlet_tpu_torch deblend 'blends/*.npz' --out results.json

Each npz must hold ``images`` (C, H, W) and ``psfs`` (C, h, w), the same
conventions as the reference's blend-set files (ref
scarlet/testing/deblend.py:9-50).  ``variance`` is optional (estimated
by per-band MAD when absent), and so is the ``catalog`` of ``y``/``x``
peak positions: files without one (or with ``--detect host``) run the
host wavelet detection first; ``--detect device`` runs the same recipe
batched on the card per shape group (`parallel.detect_peaks_device`).
Blends are grouped by scene shape and each group runs as one stream
batch (`parallel.deblend_device_stream`): init, convergence fit and
per-source measurement on the card, no per-blend host work.

Runs on the CUDA card; ``--cpu`` runs on the CPU instead.  Without a
card and without ``--cpu`` it exits non-zero and writes no records.

Writes one JSON record per blend: fluxes (K, C), centroids (K, 2),
detection SNRs, final/init logL, and iteration counts.
"""
from __future__ import annotations

import argparse
import glob
import json
import sys
import time


def _load_blend(path, detect=None):
    import numpy as np

    data = np.load(path, allow_pickle=True)
    im = np.asarray(data["images"]).astype(np.float32)
    if "variance" in data:
        var = np.asarray(data["variance"]).astype(np.float32)
    else:
        sigma = np.array([1.4826 * np.median(np.abs(b - np.median(b)))
                          for b in im])
        # a constant (dead/masked) band has MAD 0: weight 1/var would
        # blow up and dominate the fit; floor it at the cross-band level
        pos = sigma[sigma > 0]
        sigma = np.where(sigma > 0, sigma,
                         np.median(pos) if pos.size else 1.0)
        var = np.ones_like(im) * (sigma ** 2)[:, None, None]
    psfs = np.asarray(data["psfs"]).astype(np.float32)
    # sanitize non-finite / negative-variance pixels up front (the same
    # rules stream_setup applies on the device) so host AND device
    # detection see identical clean stacks: detect_peaks_device documents
    # sanitized inputs as a precondition
    bad = ~(np.isfinite(im) & np.isfinite(var)) | (var < 0)
    if bad.any():
        im = np.where(bad, np.float32(0), im)
        vcnt = np.maximum((~bad).sum(axis=(-2, -1)), 1)
        vfill = (np.where(bad, 0, var).sum(axis=(-2, -1))
                 / vcnt)[:, None, None]
        var = np.where(bad, vfill, var).astype(np.float32)
    centers = []
    if "catalog" in data and detect is None:
        centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
                   for r in data["catalog"]]
    if not centers and detect != "device":
        # no/empty catalog (or --detect host): host wavelet detection
        # (ref scarlet/detect.py:517-572 peak flow); device mode leaves
        # centers empty and detects per shape group below
        from scarlet_tpu_torch.detect import get_peaks

        centers = [(int(np.round(y)), int(np.round(x)))
                   for y, x in get_peaks(images=im, variance=var)]
        if not centers:
            centers = [(im.shape[1] // 2, im.shape[2] // 2)]
    return im, var, psfs, centers


def deblend_main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m scarlet_tpu_torch deblend",
        description="Deblend a set of npz blend files through the device "
                    "stream on the CUDA card.")
    p.add_argument("patterns", nargs="+",
                   help="npz file paths or globs")
    p.add_argument("--out", default=None,
                   help="write records to this JSON file (default stdout)")
    p.add_argument("--box-size", type=int, default=None,
                   help="source box size (odd; default: covers the scene)")
    p.add_argument("--n-slots", type=int, default=None,
                   help="component slots per blend (default 2*max sources)")
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--e-rel", type=float, default=1e-4)
    p.add_argument("--min-snr", type=float, default=50)
    p.add_argument("--check-every", type=int, default=25)
    p.add_argument("--chunk", type=int, default=128,
                   help="stream chunk size")
    p.add_argument("--compact", type=int, default=50,
                   help="convergence-compaction point (0 disables)")
    p.add_argument("--model-psf-sigma", type=float, default=0.8)
    p.add_argument("--reweight", action="store_true",
                   help="report observed-flux redistribution instead of "
                        "model fluxes")
    p.add_argument("--recipe", choices=["main", "wavelets"], default="main")
    p.add_argument("--detect", nargs="?", const="host",
                   choices=["host", "device"], default=None,
                   help="ignore any bundled catalog and detect peaks: "
                        "'host' (the host wavelet detection; also the "
                        "fallback for files WITHOUT a catalog) or "
                        "'device' (parallel.detect_peaks_device: the "
                        "same recipe batched on the device per shape "
                        "group)")
    p.add_argument("--max-peaks", type=int, default=32,
                   help="device-detection catalog slots per blend")
    p.add_argument("--redetect", type=int, default=0,
                   help="extra detect-on-residuals passes (detect -> fit "
                        "-> detect residuals -> refit); lifts crowded-"
                        "field completeness at ~2x fit cost per pass")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card; without "
                        "one the command fails)")
    args = p.parse_args(argv)

    paths = []
    for pat in args.patterns:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else [pat])
    if not paths:
        p.error("no input files matched")

    import numpy as np
    import torch

    from scarlet_tpu_torch import lite, parallel
    from scarlet_tpu_torch.device import default_device
    from scarlet_tpu_torch.lite.utils import to_numpy

    try:
        device = default_device("cpu" if args.cpu else None)
    except RuntimeError as exc:
        print(f"python -m scarlet_tpu_torch deblend: {exc} (use --cpu)",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    blends = [_load_blend(path, detect=args.detect) for path in paths]
    model_psf = lite.integrated_circular_gaussian(
        sigma=args.model_psf_sigma)[None].astype(np.float32)

    # group by scene AND psf stamp shape: each stream batch stacks both
    # into one static layout
    groups = {}
    for i, (im, var, psfs, centers) in enumerate(blends):
        groups.setdefault((im.shape, psfs.shape), []).append(i)

    records = [None] * len(paths)
    for (shape, _), idxs in groups.items():
        C, H, W = shape
        if args.detect == "device":
            # one batched detection per shape group (the same
            # starlet-footprint recipe as the host path, on the device)
            det_c, det_a, _ = parallel.detect_peaks_device(
                torch.as_tensor(np.stack([blends[i][0] for i in idxs]),
                                device=device),
                torch.as_tensor(np.stack([blends[i][1] for i in idxs]),
                                device=device),
                max_peaks=args.max_peaks)
            det_c, det_a = det_c.cpu().numpy(), det_a.cpu().numpy()
            for b, i in enumerate(idxs):
                cs = [tuple(map(int, c)) for c in det_c[b][det_a[b]]]
                if not cs:
                    cs = [(H // 2, W // 2)]
                blends[i] = blends[i][:3] + (cs,)
        K = max(len(blends[i][3]) for i in idxs)
        carr = np.zeros((len(idxs), K, 2), np.int32)
        cact = np.zeros((len(idxs), K), bool)
        for b, i in enumerate(idxs):
            cs = blends[i][3]
            carr[b, :len(cs)] = cs
            cact[b, :len(cs)] = True
        if args.box_size is None:
            cap = max(H, W) + 1
            box = cap if cap % 2 == 1 else cap - 1
        else:
            box = args.box_size
        n_slots = args.n_slots or 2 * K
        recs, _, _, g_aux = parallel.deblend_device_stream(
            np.stack([blends[i][0] for i in idxs]),
            np.stack([blends[i][1] for i in idxs]),
            np.stack([blends[i][2] for i in idxs]),
            carr, model_psf, center_active=cact, box_size=box,
            n_slots=n_slots, max_iter=args.max_iter, e_rel=args.e_rel,
            min_snr=args.min_snr, check_every=args.check_every,
            chunk=args.chunk, compact=args.compact or None,
            reweight=args.reweight, recipe=args.recipe,
            redetect=args.redetect, device=device)
        if args.redetect:
            # redetect grows the catalog: size each record from the
            # final per-blend catalog instead of the input one
            auxs = g_aux if isinstance(g_aux, list) else [g_aux]
            final_k = np.concatenate(
                [to_numpy(a["center_active"]).sum(axis=1)
                 for a in auxs]).astype(int)
        for b, i in enumerate(idxs):
            r = recs[b]
            k = int(final_k[b]) if args.redetect else len(blends[i][3])
            records[i] = {
                "file": paths[i],
                "n_sources": k,
                "n_components": int(r["n_components"]),
                "iterations": int(r["iterations"]),
                "logL": float(r["logL"]),
                "init_logL": float(r["init logL"]),
                "flux": np.asarray(r["flux"])[:k].tolist(),
                # NaN centroid = source got no component slots (overflow);
                # emit null for strict-JSON consumers
                "centroid": [
                    [None if not np.isfinite(v) else float(v) for v in c]
                    for c in np.asarray(r["centroid"])[:k]],
                # central 2nd moments (s_yy, s_xx, s_xy) of each source
                "moments": [
                    [None if not np.isfinite(v) else float(v) for v in m]
                    for m in np.asarray(r["moments"])[:k]],
                "snr": np.asarray(r["snr"])[:k].tolist(),
            }
    dt = time.perf_counter() - t0

    out = {
        "n_blends": len(paths),
        "wall_s": round(dt, 3),
        "blends_per_min": round(len(paths) / dt * 60.0, 1),
        "records": records,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
        print(f"wrote {args.out}: {len(paths)} blends in {dt:.2f}s "
              f"({out['blends_per_min']} blends/min)")
    else:
        json.dump(out, sys.stdout)
        print()
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        print("\ncommands:\n  deblend   batch-deblend npz blend files "
              "(see `python -m scarlet_tpu_torch deblend -h`)")
        return 0
    cmd = argv.pop(0)
    if cmd == "deblend":
        return deblend_main(argv)
    print(f"unknown command {cmd!r}; try `python -m scarlet_tpu_torch "
          f"--help`", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
