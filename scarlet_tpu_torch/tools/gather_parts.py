"""Where the time of K4's tiled route or K3's staged walk goes on one card:
the device time of ``grad_kernel_tiled`` (csrc/grad.cu) or
``scene_kernel_staged`` (csrc/scene.cu) with parts of it switched off.

The tool builds the kernels with ``SCARLET_GRAD_PARTS`` (``--kernel
grad``, the default) or ``SCARLET_SCENE_PARTS`` (``--kernel scene``)
defined (a library of its own beside the package's, as the build is named
by its flags), which gives the kernel a switch set at run time, and times
``kernels.grad_gather`` or ``kernels.scene_assembly`` on ``gather_ab``'s
seeded inputs for each setting.  K4's bits: 1 no walk of the tiles, 2 no
window rows outside the gradient, 4 no copies (no tile staged, no wait),
8 no g_morph stores.  K3's: 1 no walk, 2 no stores, 4 no copies (no
value staged, no wait), 8 no list (no component listed: the walk and
copies have nothing to do).  With any bit set the results are wrong by
construction: the build is a tool of attribution only, as
``mono_pass_attrib`` is for K1.  Run from a checkout's root, with a CUDA
device::

    python -m scarlet_tpu_torch.tools.gather_parts --bands 8 10 16 40
    python -m scarlet_tpu_torch.tools.gather_parts --bands 5 --blends 32 \\
        --box 81 --scene 80 80
    python -m scarlet_tpu_torch.tools.gather_parts --kernel scene \\
        --bands 10 16 40

It prints one JSON line: per band count, the device ms of each setting
(median of ``--reps`` launches, ``torch.profiler``) and the geometry.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json

# the settings timed: {label: switch bits}
PARTS = {"all": 0, "no walk": 1, "no outside rows": 2, "no copies": 4,
         "no stores": 8, "copies only": 1 | 2, "walk only": 2 | 4 | 8}
SCENE_PARTS = {"all": 0, "list only": 1 | 2 | 4, "walk without stores": 2,
               "stores only": 8, "staging only": 1 | 2, "no copies": 4,
               "walk only": 2 | 4}
KERNELS = {
    "grad": dict(flag="-DSCARLET_GRAD_PARTS", setter="scarlet_grad_set_parts",
                 parts=PARTS, key="grad_kernel", bits={
                     "1": "no walk", "2": "no outside rows",
                     "4": "no copies", "8": "no stores"}),
    "scene": dict(flag="-DSCARLET_SCENE_PARTS",
                  setter="scarlet_scene_set_parts", parts=SCENE_PARTS,
                  key="scene_kernel", bits={
                      "1": "no walk", "2": "no stores", "4": "no copies",
                      "8": "no list"}),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="grad")
    ap.add_argument("--bands", type=int, nargs="+", default=[8, 10, 16, 40])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--blends", type=int, default=128)
    ap.add_argument("--components", type=int, default=16)
    ap.add_argument("--scene", type=int, nargs=2, default=(58, 48))
    ap.add_argument("--box", type=int, default=59)
    args = ap.parse_args(argv)
    shape = (args.blends, args.components, tuple(args.scene), args.box)
    spec = KERNELS[args.kernel]

    import torch

    from scarlet_tpu_torch.ops import build, kernels as kn
    from scarlet_tpu_torch.tools import gather_ab as ab

    # before the first load: this process runs the switched build
    build._FLAGS = build._FLAGS + (spec["flag"],)
    lib = build.load()
    setter = getattr(lib, spec["setter"])
    setter.argtypes = [ctypes.c_int]
    if args.kernel == "scene":   # the staged walk at every band count
        kn.scene_geometry = functools.partial(kn.scene_geometry,
                                              route="staged")
    B, K, (H, W), box = shape
    res = {}
    for C in args.bands:
        seds, m, org, on, grad = ab._inputs(C, 100 + C, shape)
        if args.kernel == "grad":
            geo = kn.grad_geometry(B, K, C, H, W, box, box)
            if geo.staged:
                raise ValueError(f"C={C} at {shape} takes the staged route")

            def call():
                return kn.grad_gather(grad, seds, m, org, 0)
        else:
            geo = kn.scene_geometry(B, K, C, H, W)

            def call():
                return kn.scene_assembly(seds, m, org, on, (C, H, W), box)
        ms = {}
        for label, bits in spec["parts"].items():
            if setter(bits) != 0:
                raise RuntimeError("could not set the switch")
            torch.cuda.synchronize()
            ms[label] = ab._device_ms(call, spec["key"], args.reps)
        setter(0)
        res[C] = dict(ms=ms, geometry=geo._asdict())
    out = dict(kernel=args.kernel, shape=shape, reps=args.reps,
               bits=spec["bits"], parts=res)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
