"""Multiscale deblending on the masked simulation field testdata_3_0
(the reference's multiscale_deblending tutorial; the JAX package's
examples/multiscale_deblending.py): wavelet detection, a lite fit with a
footprint mask folded into the weights, and a ``LiteBlend`` with a custom
gradient in starlet-coefficient space, stepped through the eager
per-component ``update`` API.

    python -m scarlet_tpu_torch.examples.multiscale_deblending
"""
import numpy as np
import torch

import scarlet_tpu_torch as st
from scarlet_tpu_torch import lite
from scarlet_tpu_torch.ops.wavelet import multiband_starlet_transform
from scarlet_tpu_torch.examples._common import Run, fast_env, load_npz


def load():
    return load_npz("testdata_3_0.npz")


class WaveletBlend(lite.LiteBlend):
    """Match the data in starlet space: the gradient weighs the residuals
    per wavelet scale, which favours compact structure over the smooth
    background (the tutorial's WaveletBlend, multiscale_deblending.ipynb
    cell 3).  Runs on the observation's device."""

    scales = 3
    generation = 1

    def __init__(self, sources, observation):
        super().__init__(sources, observation)
        self.data_wavelets = multiband_starlet_transform(
            observation.images, scales=self.scales,
            generation=self.generation)

    def grad_logL(self):
        obs = self.observation
        model = torch.as_tensor(self.get_model(convolve=True),
                                device=obs.device)
        # the pixel-space loss drives the convergence check
        self.loss.append(float(
            -0.5 * torch.sum(obs.weights * (obs.images - model) ** 2)))
        wavelets = multiband_starlet_transform(
            model, scales=self.scales, generation=self.generation)
        grad = torch.sum(obs.weights[None] * (wavelets - self.data_wavelets),
                         dim=0)
        return obs.convolve(grad, grad=True)

    def fit(self, max_iter, e_rel=1e-4, min_iter=1, resize=10):
        """The eager loop over the per-component update API (ref
        lite/models.py:589-624); the engine runs only the standard
        pixel-space gradient."""
        while self.it < max_iter:
            grad = self.grad_logL()
            for component in self.components:
                component.update(self.it, grad)
            if resize is not None and self.it > 0 and self.it % resize == 0:
                for component in self.components:
                    if hasattr(component, "resize"):
                        component.resize()
            if (self.it > min_iter and len(self.loss) > 1 and
                    abs(self.loss[-1] - self.loss[-2])
                    < e_rel * abs(self.loss[-1])):
                break
            self.it += 1
        return self.it, self.loss[-1]


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    images = data["images"].astype(np.float32)
    variance = data["variance"].astype(np.float32)
    footprint = data["footprint"]      # True where a neighbouring blend sits
    psfs = data["psfs"].astype(np.float32)

    # the neighbouring footprint is masked out of the likelihood
    weights = (1.0 / np.maximum(variance, 1e-12)).astype(np.float32)
    weights *= ~footprint[None, :, :]

    # wavelet detection (ref notebook cell 1): more peaks than the catalog
    detect = st.detect.get_detect_wavelets(images, variance, scales=5)
    peaks = st.detect.get_peaks(detect=detect * ~footprint[None, :, :])
    centers = [(int(round(p[0])), int(round(p[1]))) for p in peaks]
    print(f"wavelet detection found {len(centers)} peaks "
          f"(bundled catalog lists {len(data['centers'])})")

    # the standard lite fit with masked weights
    model_psf = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
        np.float32)
    obs = lite.LiteObservation(images, variance, weights, psfs,
                               model_psf=model_psf, device=r.device)
    sources = lite.init_all_sources_main(obs, centers)
    sources = lite.parameterize_sources(sources, obs,
                                        lite.init_adaprox_component)
    blend = lite.LiteBlend(sources, obs)
    # the joint linear SED solve first: on this high-SNR simulation it
    # takes the start from chi2/dof ~1450 to ~2
    blend.fit_spectra()
    r.lap("init")
    max_iter = 12 if fast else 80
    blend.fit(max_iter, e_rel=1e-4, resize=10)
    print(f"masked fit: {blend.it} iterations, logL = {blend.loss[-1]:.1f}")

    model = blend.get_model(convolve=True)
    resid = (images - model) * (weights > 0)
    chi2 = float(np.sum(weights * (images - model) ** 2)
                 / max(np.sum(weights > 0), 1))
    print(f"chi2/dof over unmasked pixels = {chi2:.2f}")
    r.lap("fit")

    wsources = lite.init_all_sources_main(obs, centers)
    wsources = lite.parameterize_sources(wsources, obs,
                                         lite.init_adaprox_component)
    wblend = WaveletBlend(wsources, obs)
    wblend.fit_spectra()
    r.lap("init")
    # the eager loop pays a dispatch per component and iteration: a short
    # run shows the hook
    wblend.fit(3 if fast else 8)
    print(f"wavelet-gradient fit: {wblend.it} iterations, "
          f"logL = {wblend.loss[-1]:.1f}")
    r.lap("fit")

    # the display with the mask rendered transparent
    norm = st.display.AsinhPercentileNorm(images)
    scene = [("data (masked)", st.display.img_to_rgb(images, norm=norm,
                                                     mask=footprint)),
             ("model", st.display.img_to_rgb(model, norm=norm)),
             ("residual", st.display.img_to_rgb(resid, norm=norm))]

    def draw_scene(plt):
        fig, ax = plt.subplots(1, 3, figsize=(12, 4))
        for a, (title, rgb) in zip(ax, scene):
            a.imshow(rgb)
            a.set_title(title)
            a.axis("off")
        for cy, cx in centers:
            ax[0].plot(cx, cy, "wx", ms=4)
        return fig

    r.figure("multiscale_scene.png", [rgb for _, rgb in scene], draw_scene,
             dpi=90)
    r.lap("display")
    return r.result(peaks=len(centers), iterations=int(blend.it),
                    logL=[float(blend.loss[0]), float(blend.loss[-1])],
                    chi2=chi2, wavelet_iterations=int(wblend.it),
                    wavelet_logL=[float(wblend.loss[0]),
                                  float(wblend.loss[-1])])


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
