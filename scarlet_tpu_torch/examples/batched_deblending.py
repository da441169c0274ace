"""Batched deblending: many blends fitted at once by the engine, on a
mesh of devices (the JAX package's examples/batched_deblending.py).  One
blend is initialized on the host, replicated into a batch, placed on the
mesh and fitted until every blend converges.

    python -m scarlet_tpu_torch.examples.batched_deblending

Without a ``torch.distributed`` process group, ``parallel.make_mesh()``
is the one-device mesh of the card (or of the CPU with ``device="cpu"``):
no group is started.
"""
import time

import numpy as np
import torch

from scarlet_tpu_torch import lite, parallel
from scarlet_tpu_torch.examples._common import Run, fast_env, load_npz


def load():
    return load_npz("hsc_cosmos_35.npz")


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    # one blend, initialized on the host for a fit on the run's device
    images = data["images"].astype(np.float32)
    variance = data["variance"].astype(np.float32)
    weights = (1 / np.maximum(variance, 1e-12)).astype(np.float32)

    obs = lite.LiteObservation(
        images, variance, weights, data["psfs"].astype(np.float32),
        model_psf=lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
            np.float32), device="cpu")
    centers = [(int(round(c["y"])), int(round(c["x"])))
               for c in data["catalog"]]
    sources = lite.parameterize_sources(
        lite.init_all_sources_main(obs, centers), obs,
        lite.init_adaprox_component)
    blend = lite.LiteBlend(sources, obs)
    config, blend_data, state = blend.engine_setup(
        e_rel=1e-4, device="cpu", platform=r.device.type)

    # replicated into a batch (in production: pack_blends over many blends)
    BATCH = 8 if fast else 256
    bdata, bstate = parallel.replicate_blend(blend_data, state, BATCH)

    # over every device of the mesh
    mesh = parallel.make_mesh(device_type=r.device.type)
    bdata, bstate = parallel.shard_batch(bdata, bstate, mesh)
    r.lap("init")

    # a warm-up (the kernels' build), then the timed fit
    iters = 10 if fast else 100
    out, losses = parallel.fit_batch_converged(bstate, bdata, config, iters)
    _ = float(torch.sum(out.last_loss))
    r.lap("fit")

    t0 = time.perf_counter()
    out, losses = parallel.fit_batch_converged(bstate, bdata, config, iters)
    _ = float(torch.sum(out.last_loss))
    dt = time.perf_counter() - t0
    r.lap("fit")

    print(f"{BATCH} blends x {losses.shape[0]} iterations in {dt:.2f}s "
          f"= {BATCH / dt * 60:.0f} blends/min on {mesh.size()} device(s)")
    print(f"median final logL: {float(torch.median(losses[-1])):.1f}")
    return r.result(blends=BATCH, iterations=int(losses.shape[0]),
                    blends_per_min=BATCH / dt * 60,
                    logL=[float(torch.median(losses[0])),
                          float(torch.median(losses[-1]))])


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
