"""Production stream deblending: raw pixel stacks to measured fluxes on
the device (the JAX package's examples/stream_deblending.py).

``parallel.deblend_device_stream`` runs the whole catalog-scale pipeline
(batched device initialization: detection coadds, monotonic seeds,
SNR-gated bulge/disk splits with joint least-squares SEDs, PSF
fallbacks; the batched converged fit; per-source flux measurement) with
no per-blend host work; ``chunk=`` pipelines each chunk's upload and
init behind the previous chunk's fit.

    python -m scarlet_tpu_torch.examples.stream_deblending
"""
import time

import numpy as np

from scarlet_tpu_torch import lite, parallel
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.examples._common import Run, fast_env, load_npz


def load():
    return load_npz("hsc_cosmos_35.npz")


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    N = 8 if fast else 64
    MAX_ITER = 15 if fast else 100

    # a stream of distinct blends from the one HSC blend
    images = data["images"].astype(np.float32)
    variance = data["variance"].astype(np.float32)
    psfs = data["psfs"].astype(np.float32)
    centers = np.asarray([(int(round(c["y"])), int(round(c["x"])))
                          for c in data["catalog"]])

    rng = np.random.default_rng(0)
    stack_images = np.stack([
        images + rng.standard_normal(images.shape).astype(np.float32)
        * np.sqrt(variance) * 0.3
        for _ in range(N)])
    stack_var = np.repeat(variance[None], N, axis=0)
    stack_psfs = np.repeat(psfs[None], N, axis=0)
    stack_centers = np.repeat(centers[None], N, axis=0)
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    r.lap("init")

    # the whole stream on the device
    t0 = time.perf_counter()
    records, state, losses, aux = parallel.deblend_device_stream(
        stack_images, stack_var, stack_psfs, stack_centers, model_psf,
        box_size=59, n_slots=10, max_iter=MAX_ITER, check_every=MAX_ITER,
        reweight=not fast, chunk=None if N <= 16 else N // 2,
        device=r.device)
    dt = time.perf_counter() - t0
    print(f"deblended {N} blends in {dt:.2f}s ({N / dt * 60:.0f} "
          "blends/min, incl. the kernels' build on a first run)")
    rec = records[0]
    print(f"blend 0: {rec['n_components']} components, "
          f"{rec['iterations']} its, logL {rec['logL']:.1f}")
    print("per-source flux (summed over bands):",
          np.round(np.asarray(rec["flux"]).sum(axis=1), 1))
    print("per-source centroids (y, x):",
          np.round(np.asarray(rec["centroid"]), 1))
    print("per-source detection SNR:", np.round(np.asarray(rec["snr"]), 1))
    assert all(np.isfinite(x["logL"]) for x in records)
    assert all(x["logL"] > x["init logL"] for x in records)

    # the wavelet initialization recipe (starlet detection dictionaries,
    # bulge/disk from scale slices: the lite tutorial's init) on the same
    # stream; and convergence compaction (``compact=``), which gathers the
    # blends still running after ``compact`` iterations into one smaller
    # batch, so early stoppers save wall-clock on mixed streams
    wrecords, *_ = parallel.deblend_device_stream(
        stack_images[:4], stack_var[:4], stack_psfs[:4], stack_centers[:4],
        model_psf, box_size=61, n_slots=10, max_iter=MAX_ITER,
        check_every=MAX_ITER, recipe="wavelets",
        compact=None if MAX_ITER < 30 else 50, device=r.device)
    print("wavelet-recipe blend 0:",
          f"{wrecords[0]['n_components']} components, "
          f"logL {wrecords[0]['logL']:.1f}")
    assert all(np.isfinite(x["logL"]) for x in wrecords)

    # no catalog: centers=None detects on the device
    # (``parallel.detect_peaks_device``, the reference's starlet-footprint
    # peak recipe) per chunk, raw pixels to catalog to fluxes
    drecords, _, _, daux = parallel.deblend_device_stream(
        stack_images[:4], stack_var[:4], stack_psfs[:4], None, model_psf,
        box_size=59, n_slots=10, max_iter=MAX_ITER, check_every=MAX_ITER,
        device=r.device)
    det = to_numpy(daux["centers"][0])[to_numpy(daux["center_active"][0])]
    print(f"device detection blend 0: {len(det)} peaks "
          f"(catalog has {len(centers)}), logL {drecords[0]['logL']:.1f}")
    assert all(np.isfinite(x["logL"]) for x in drecords)
    print("OK")
    r.lap("fit")

    def logL(recs):
        """The records' summed logL at the init and at the end."""
        return [float(sum(x["init logL"] for x in recs)),
                float(sum(x["logL"] for x in recs))]

    return r.result(blends=N, blends_per_min=N / dt * 60,
                    iterations=[int(x["iterations"]) for x in records],
                    logL=logL(records), wavelet_logL=logL(wrecords),
                    detect_logL=logL(drecords), detected=len(det))


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
