"""Displaying scenes: Lupton RGB mapping, channel maps and the display
helpers (the reference's docs/tutorials/display.ipynb flow; the JAX
package's examples/display_tutorial.py): the norm sweep (an AsinhMapping
stretch/Q grid), ``channels_to_rgb`` defaults, a custom channel map,
``show_scene`` panels, ``show_sources`` (one multi-component source too),
``show_observation`` with the PSF panel, and the likelihood history.

    python -m scarlet_tpu_torch.examples.display_tutorial
"""
import numpy as np

import scarlet_tpu_torch as st
from scarlet_tpu_torch.display import AsinhMapping, channels_to_rgb, img_to_rgb
from scarlet_tpu_torch.examples._common import Run, fast_env, load_npz


def load():
    return load_npz("hsc_cosmos_35.npz")


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    images = data["images"].astype(np.float32)
    weights = (1 / np.maximum(data["variance"], 1e-12)).astype(np.float32)
    channels = list("grizy")

    obs = st.Observation(images, psf=st.ImagePSF(data["psfs"].astype(
        np.float32)), weights=weights, channels=channels, device=r.device)
    r.lap("init")

    # the norm sweep (ref display.ipynb cell 1): the arcsinh scaling
    # f(x) = asinh(Q (x - min)/stretch)/Q keeps colour from bright to
    # faint; pick stretch and Q by eye on a 3 x 3 grid
    sweep = []
    for stretch in [0.01, 0.1, 1]:
        for Q in [1, 10, 100]:
            asinh = AsinhMapping(minimum=0, stretch=stretch, Q=Q)
            img_rgb = img_to_rgb(images, norm=asinh)
            assert img_rgb.shape == images.shape[1:] + (3,)
            sweep.append((f"Stretch {stretch}, Q {Q}", img_rgb))

    def draw_sweep(plt):
        fig, ax = plt.subplots(3, 3, figsize=(9, 12))
        for a, (title, img_rgb) in zip(ax.flat, sweep):
            a.imshow(img_rgb)
            a.set_title(title)
            a.axis("off")
        return fig

    r.figure("display_norm_sweep.png", [rgb for _, rgb in sweep],
             draw_sweep, dpi=80)

    # Q=10, stretch=0.1 looks reasonable; minimum=0 renders negative sky
    # as black (fine for background-subtracted images)
    norm = AsinhMapping(minimum=0, stretch=0.1, Q=10)

    # channel maps (ref cells 6-8): a (3, C) linear map takes C
    # wavelength-ordered bands onto RGB before the intensity norm
    print("Mapping from 1 band to RGB:\n", channels_to_rgb(1))
    print("Mapping from 3 bands to RGB:\n", channels_to_rgb(3))
    print("Mapping from 5 bands to RGB:\n", channels_to_rgb(5))

    # de-weight the noisy reddest (Y) band in the red display channel
    channel_map = channels_to_rgb(5)
    channel_map[0, :] = [0, 0, 0.2, 0.5, 0.3]
    channel_map /= channel_map.sum(axis=1)[:, None]
    print("New channel map:\n", channel_map)

    maps = [("Default", img_to_rgb(images, norm=norm)),
            ("Less Y", img_to_rgb(images, norm=norm,
                                  channel_map=channel_map))]

    def draw_maps(plt):
        fig, ax = plt.subplots(1, 2, figsize=(9, 12))
        for a, (title, img_rgb) in zip(ax, maps):
            a.imshow(img_rgb)
            a.set_title(title)
            a.axis("off")
        return fig

    r.figure("display_channel_map.png", [rgb for _, rgb in maps], draw_maps,
             dpi=80)
    r.lap("display")

    # a quick model to display (the quickstart scene)
    model_frame = st.Frame(images.shape, channels=channels,
                           psf=st.GaussianPSF(sigma=0.8, boxsize=15))
    obs = obs.match(model_frame)
    centers = [(float(c["y"]), float(c["x"])) for c in data["catalog"]]
    sources, skipped = st.initialization.init_all_sources(
        model_frame, centers, obs, max_components=2, min_snr=30, silent=True)
    r.lap("init")
    blend = st.Blend(sources, obs)
    max_iter = 12 if fast else 60
    it, logL = blend.fit(max_iter, e_rel=1e-4)
    print(f"fit: {it} iterations, logL = {logL:.1f}")
    r.lap("fit")

    # show_sources (ref cells 15-17) takes one multi-component source too:
    # the model tree is iterable (ref scarlet/model.py:62-66), so its
    # components show apart
    multi = next(s for s in sources if len(s.children) > 1)
    assert list(multi) == list(multi.children) and \
        multi[0] is multi.children[0]
    # show_scene (ref cells 10-13): the model alone, then model, rendered,
    # observed and residual against the matched observation
    r.show("display_scene_model.png", st.display.show_scene, sources,
           norm=norm, channel_map=channel_map, dpi=80)
    r.show("display_scene_full.png", st.display.show_scene, sources,
           observation=obs, norm=norm, channel_map=channel_map,
           show_rendered=True, show_observed=True, show_residual=True,
           add_boxes=True, dpi=80)

    # every source with its spectrum, then the multi-component one
    r.show("display_sources.png", st.display.show_sources, sources,
           norm=norm, channel_map=channel_map, dpi=80)
    r.show("display_source_components.png", st.display.show_sources, multi,
           norm=norm, channel_map=channel_map, observation=obs,
           show_rendered=True, show_observed=True, add_markers=True, dpi=80)

    # show_observation with the PSF panel, and the likelihood history
    r.show("display_observation.png", st.display.show_observation, obs,
           norm=norm, channel_map=channel_map, sky_coords=centers,
           show_psf=True, dpi=80)
    r.show("display_likelihood.png", st.display.show_likelihood, blend,
           dpi=80)
    r.lap("display")
    return r.result(iterations=int(it),
                    logL=[float(blend.log_likelihood[0]), float(logL)],
                    sources=len(sources), skipped=list(skipped))


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
