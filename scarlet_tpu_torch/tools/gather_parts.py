"""Where the time of K4's tiled route goes on one card: the device time of
``grad_kernel_tiled`` (csrc/grad.cu) with parts of it switched off.

The tool builds the kernels with ``SCARLET_GRAD_PARTS`` defined (a
library of its own beside the package's, as the build is named by its
flags), which gives ``grad_kernel_tiled`` a switch set at run time, and
times ``kernels.grad_gather`` on ``gather_ab``'s seeded inputs for each
setting.  The bits: 1 no walk of the tiles, 2 no window rows outside the
gradient, 4 no copies (no tile staged, no wait), 8 no g_morph stores.
With any bit set the results are wrong by construction: the build is a
tool of attribution only, as ``mono_pass_attrib`` is for K1.  Run from a
checkout's root, with a CUDA device::

    python -m scarlet_tpu_torch.tools.gather_parts --bands 8 10 16 40
    python -m scarlet_tpu_torch.tools.gather_parts --bands 5 --blends 32 \\
        --box 81 --scene 80 80

It prints one JSON line: per band count, the device ms of each setting
(median of ``--reps`` launches, ``torch.profiler``) and the geometry.
"""
from __future__ import annotations

import argparse
import ctypes
import json

# the settings timed: {label: switch bits}
PARTS = {"all": 0, "no walk": 1, "no outside rows": 2, "no copies": 4,
         "no stores": 8, "copies only": 1 | 2, "walk only": 2 | 4 | 8}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", type=int, nargs="+", default=[8, 10, 16, 40])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--blends", type=int, default=128)
    ap.add_argument("--components", type=int, default=16)
    ap.add_argument("--scene", type=int, nargs=2, default=(58, 48))
    ap.add_argument("--box", type=int, default=59)
    args = ap.parse_args(argv)
    shape = (args.blends, args.components, tuple(args.scene), args.box)

    import torch

    from scarlet_tpu_torch.ops import build, kernels as kn
    from scarlet_tpu_torch.tools import gather_ab as ab

    # before the first load: this process runs the switched build
    build._FLAGS = build._FLAGS + ("-DSCARLET_GRAD_PARTS",)
    lib = build.load()
    lib.scarlet_grad_set_parts.argtypes = [ctypes.c_int]
    B, K, (H, W), box = shape
    res = {}
    for C in args.bands:
        geo = kn.grad_geometry(B, K, C, H, W, box, box)
        if geo.staged:
            raise ValueError(f"C={C} at {shape} takes the staged route")
        seds, m, org, _, grad = ab._inputs(C, 100 + C, shape)
        ms = {}
        for label, bits in PARTS.items():
            if lib.scarlet_grad_set_parts(bits) != 0:
                raise RuntimeError("could not set the switch")
            torch.cuda.synchronize()
            ms[label] = ab._device_ms(lambda: kn.grad_gather(
                grad, seds, m, org, 0), "grad_kernel", args.reps)
        lib.scarlet_grad_set_parts(0)
        res[C] = dict(ms=ms, geometry=geo._asdict())
    out = dict(shape=shape, reps=args.reps, bits={
        "1": "no walk", "2": "no outside rows", "4": "no copies",
        "8": "no stores"}, parts=res)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
