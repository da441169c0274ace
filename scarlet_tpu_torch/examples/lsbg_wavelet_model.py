"""Low-surface-brightness galaxy modelling: the reference's
``wavelet_model.ipynb`` tutorial flow on its data file lsbg.pkl (the JAX
package's examples/lsbg_wavelet_model.py).

A full-frame :class:`StarletSource` (no centre: it seeds from a
``RandomSource``, ref source.py:569-571) absorbs the diffuse emission
while compact sources model the point-like contaminants; the LSBG is then
separated from the scene by SED cosine similarity (tutorial cell 23).

    python -m scarlet_tpu_torch.examples.lsbg_wavelet_model
"""
import pickle

import numpy as np
import torch

import scarlet_tpu_torch as st
from scarlet_tpu_torch.display import AsinhMapping
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.examples._common import Run, data_path, fast_env


class _Stub:
    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        pass


class _TolerantUnpickler(pickle.Unpickler):
    """Stands a stub in for a class that cannot be imported (the file's
    astropy WCS, which the tutorial never uses)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


def load():
    with open(data_path("lsbg.pkl"), "rb") as f:
        return _TolerantUnpickler(f).load()


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    images = np.asarray(data["images"], np.float32)
    filters = list(data["channels"])
    psfs = np.asarray(data["psfs"], np.float32)
    print(f"lsbg field: {images.shape} in {filters}")

    norm = AsinhMapping(minimum=0, stretch=1, Q=5)

    # model frame and observation (tutorial cell 7)
    model_frame = st.Frame(images.shape,
                           psf=st.GaussianPSF(sigma=0.8, boxsize=15),
                           channels=filters)
    observation = st.Observation(images, psf=st.ImagePSF(psfs),
                                 channels=filters,
                                 device=r.device).match(model_frame)

    # wavelet detection (tutorial cells 9-13)
    detect_image = np.sum(images, axis=0)
    coeffs = st.ops.wavelet.starlet_transform(
        torch.from_numpy(detect_image), scales=3).numpy()
    M = st.ops.wavelet.get_multiresolution_support(
        detect_image, coeffs, 0.1, K=3, epsilon=1e-1, max_iter=20)
    detect = M * coeffs
    detect[detect < 0] = 0

    # the starlet round trip (tutorial cell 11)
    recon = st.ops.wavelet.starlet_reconstruction(
        torch.from_numpy(coeffs)).numpy()
    assert np.allclose(recon, detect_image,
                       atol=1e-4 * np.abs(detect_image).max())

    footprints = st.detect.get_footprints(detect[1], min_separation=0,
                                          min_area=10, thresh=0)
    peaks = [p for fp in footprints for p in fp.peaks]
    print(f"{len(footprints)} footprints with {len(peaks)} peaks "
          "at the 2nd wavelet scale")

    # sources: compact detections and one full-frame starlet source, whose
    # seed draws from numpy's global stream
    centers = [(p.y, p.x) for p in peaks]
    sources, skipped = st.initialization.init_all_sources(
        model_frame, centers, observation, max_components=1, min_snr=50,
        thresh=1, fallback=True, silent=True, set_spectra=False)
    print(f"{len(sources)} compact sources ({len(skipped)} skipped)")

    np.random.seed(0)
    sources.append(st.StarletSource(model_frame))
    r.lap("init")

    # fit (tutorial cell 17)
    blend = st.Blend(sources, observation)
    n_iter, e_rel = (20, 1e-4) if fast else (200, 1e-6)
    it, logL = blend.fit(n_iter, e_rel=e_rel)
    print(f"fit ran {it} iterations to logL = {logL:.1f}")
    r.lap("fit")

    r.show("lsbg_likelihood.png", st.display.show_likelihood, blend, dpi=80)
    r.show("lsbg_scene.png", st.display.show_scene, sources, norm=norm,
           observation=observation, show_rendered=True, show_observed=True,
           show_residual=True, dpi=80)
    r.lap("display")

    # LSBG separation by SED cosine similarity (tutorial cell 23)
    spectrum = to_numpy(sources[-1].spectrum.get_model())
    C = np.zeros(len(sources))
    for j, src in enumerate(sources):
        s = to_numpy(src.spectrum.get_model())
        C[j] = spectrum @ s / (np.linalg.norm(spectrum) * np.linalg.norm(s))

    members = [j for j in range(len(sources)) if C[j] > 0.995]
    print(f"sources with LSBG-like SEDs (cos > 0.995): {members}")
    lsbg = sum(to_numpy(sources[j].get_model(frame=model_frame))
               for j in members)
    lsbg_rendered = to_numpy(observation.render(torch.as_tensor(
        lsbg, dtype=observation.data.dtype, device=observation.device)))
    r.lap("fit")

    separation = [
        ("Image", st.display.img_to_rgb(images, norm=norm)),
        ("Image - LSBG", st.display.img_to_rgb(images - lsbg_rendered,
                                               norm=norm)),
        ("LSBG", st.display.img_to_rgb(lsbg_rendered, norm=norm))]

    def draw_separation(plt):
        fig, ax = plt.subplots(1, 3, figsize=(15, 5))
        for a, (title, rgb) in zip(ax, separation):
            a.imshow(rgb)
            a.set_title(title)
        return fig

    r.figure("lsbg_separation.png", [rgb for _, rgb in separation],
             draw_separation, dpi=80)
    r.lap("display")

    # the diffuse component must carry real flux
    lsbg_flux = float(np.sum(lsbg_rendered))
    assert lsbg_flux > 0
    if r.files:
        print("figures written to", r.out_dir)
    return r.result(iterations=int(it), peaks=len(peaks),
                    sources=len(sources), members=members,
                    logL=[float(blend.log_likelihood[0]), float(logL)],
                    lsbg_flux=lsbg_flux)


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
