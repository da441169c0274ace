"""Starlet (wavelet) morphology modelling: the brightest galaxy of the HSC
blend as a ``StarletSource`` (the reference's wavelet_model tutorial
flow; the JAX package's examples/starlet_source.py) beside
``SingleExtendedSource`` neighbours.

    python -m scarlet_tpu_torch.examples.starlet_source
"""
import numpy as np

import scarlet_tpu_torch as st
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.examples._common import Run, fast_env, load_npz


def load():
    return load_npz("hsc_cosmos_35.npz")


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    images = data["images"].astype(np.float32)
    weights = (1 / np.maximum(data["variance"], 1e-12)).astype(np.float32)
    channels = list("grizy")

    model_frame = st.Frame(images.shape, channels=channels,
                           psf=st.GaussianPSF(sigma=0.8, boxsize=15))
    obs = st.Observation(images, psf=st.ImagePSF(data["psfs"].astype(
        np.float32)), weights=weights, channels=channels,
        device=r.device).match(model_frame)

    centers = [(float(c["y"]), float(c["x"])) for c in data["catalog"]]

    # detection with starlets (detect.py): peaks at the 2nd wavelet scale
    peaks = st.detect.get_peaks(images=images,
                                variance=data["variance"].astype(np.float32))
    print(f"wavelet detection found {len(peaks)} peaks "
          f"(catalog has {len(centers)})")

    # the brightest source gets an overcomplete starlet morphology with a
    # sparsity threshold per scale; its neighbours extended sources
    sources = [st.StarletSource(model_frame, centers[0], obs,
                                starlet_thresh=5e-3)]
    for center in centers[1:]:
        sources.append(st.SingleExtendedSource(model_frame, center, obs))
    r.lap("init")

    blend = st.Blend(sources, obs)
    max_iter = 12 if fast else 80
    it, logL = blend.fit(max_iter, e_rel=1e-4)
    print(f"fit: {it} iterations, logL = {logL:.1f}")

    starlet_model = to_numpy(sources[0].get_model())
    flux = st.measure.flux(sources[0])
    print(f"starlet source: {starlet_model.shape} model, "
          f"flux {flux.round(1)}")
    r.lap("fit")

    r.show("starlet_scene.png", st.display.show_scene, sources, obs,
           show_rendered=True, show_observed=True, show_residual=True, dpi=90)
    r.lap("display")
    return r.result(iterations=int(it), peaks=len(peaks),
                    logL=[float(blend.log_likelihood[0]), float(logL)],
                    starlet_shape=list(starlet_model.shape),
                    starlet_flux=np.asarray(flux).tolist())


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
