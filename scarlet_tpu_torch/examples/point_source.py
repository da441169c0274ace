"""Point sources and galaxies in one scene (the reference's
docs/tutorials/point_source.ipynb flow; the JAX package's
examples/point_source.py): stars get ``PointSource`` (PSF morphology,
centre free), galaxies ``ExtendedSource``, and both fit in one Blend.

    python -m scarlet_tpu_torch.examples.point_source
"""
import numpy as np

import scarlet_tpu_torch as st
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.examples._common import Run, fast_env, load_npz


def load():
    return load_npz("psf_unmatched_sim.npz")


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    images = data["images"].astype(np.float32)
    filters = [str(f) for f in data["filters"]]
    psfs = data["psfs"].astype(np.float32)
    catalog = data["catalog"]
    # a flat background noise estimate, as in the tutorial
    weights = np.ones_like(images) / 2 ** 2

    model_frame = st.Frame(images.shape, channels=filters,
                           psf=st.GaussianPSF(sigma=0.9))
    obs = st.Observation(images, psf=st.ImagePSF(psfs), weights=weights,
                         channels=filters, device=r.device).match(model_frame)

    sources, rows = [], []
    for idx in np.unique(catalog["index"]):
        src = catalog[catalog["index"] == idx][0]
        coord = (float(src["y"]), float(src["x"]))
        if src["is_star"]:
            sources.append(st.PointSource(model_frame, coord, obs))
        else:
            sources.append(st.ExtendedSource(model_frame, coord, obs))
        rows.append(src)
    n_star = int(np.sum([row["is_star"] for row in rows]))
    print(f"initialized {len(sources)} sources ({n_star} stars)")
    r.lap("init")

    blend = st.Blend(sources, obs)
    max_iter = 12 if fast else 200
    it, logL = blend.fit(max_iter, e_rel=1e-4)
    print(f"fit ran {it} iterations to logL = {logL:.1f}")

    # the fitted star centres track the catalog positions
    stars = []
    for k, (src, row) in enumerate(zip(sources, rows)):
        if isinstance(src, st.PointSource):
            cy, cx = np.asarray(src.center)
            stars.append([float(cy), float(cx)])
            print(f"  star {k}: center=({cy:.2f}, {cx:.2f}) "
                  f"truth=({row['y']:.2f}, {row['x']:.2f})")
    r.lap("fit")

    norm = st.display.AsinhMapping(minimum=0, stretch=images.max() / 20,
                                   Q=10)
    r.show("point_source_scene.png", st.display.show_scene, sources,
           observation=obs, norm=norm, show_rendered=True, show_observed=True,
           show_residual=True, dpi=72)
    r.show("point_source_sources.png", st.display.show_sources, sources,
           observation=obs, norm=norm, show_rendered=True, show_observed=True,
           add_boxes=True, dpi=72)
    r.show("point_source_likelihood.png", st.display.show_likelihood, blend,
           dpi=72)
    r.lap("display")

    model = to_numpy(obs.render(blend.get_model()))
    chi2 = float(np.mean(weights * (images - model) ** 2))
    print(f"chi2/dof = {chi2:.3f}")
    return r.result(iterations=int(it),
                    logL=[float(blend.log_likelihood[0]), float(logL)],
                    sources=len(sources), stars=stars, chi2=chi2)


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
