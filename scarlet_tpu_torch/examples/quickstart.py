"""Quickstart: deblend the HSC blend hsc_cosmos_35 (the reference's
docs/0-quickstart.ipynb flow; the JAX package's examples/quickstart.py):
initialization, fit, the scene figure, a pickle round trip of the fitted
sources and a refit with a source added at the residual peak.

    python -m scarlet_tpu_torch.examples.quickstart
"""
import pickle

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
    sources, skipped = st.initialization.init_all_sources(
        model_frame, centers, obs, max_components=2, min_snr=30, silent=True)
    print(f"initialized {len(sources)} sources (skipped {skipped})")
    r.lap("init")

    blend = st.Blend(sources, obs)
    max_iter = 12 if fast else 100
    it, logL = blend.fit(max_iter, e_rel=1e-4)
    print(f"fit converged after {it} iterations to logL = {logL:.1f}")
    fluxes = [st.measure.flux(src) for src in sources]
    for k, flux in enumerate(fluxes):
        print(f"  source {k}: flux per band = {np.round(flux, 1)}")
    r.lap("fit")

    r.show("quickstart_scene.png", st.display.show_scene, sources, obs,
           show_observed=True, show_rendered=True, show_residual=True,
           norm=st.display.AsinhPercentileNorm(images), dpi=100)
    r.lap("display")

    # the fitted scene pickles with its optimizer moments (the reference's
    # "hsc_cosmos_35.sca" cells), so a reload warm-starts; parameters
    # unpickle as host tensors, and go to the observation's device, where
    # a fit would put them
    sca = r.path("hsc_cosmos_35.sca")
    with open(sca, "wb") as f:
        pickle.dump(sources, f)
    with open(sca, "rb") as f:
        sources2 = pickle.load(f)
    for src in sources2:
        for p in src.parameters:
            p.to(obs.device)
    model0 = blend.get_model()
    blend2 = st.Blend(sources2, obs)
    np.testing.assert_allclose(to_numpy(blend2.get_model()),
                               to_numpy(model0), rtol=1e-6)
    print("pickle round trip: model preserved")

    # refit the reloaded scene with a source added at the residual peak
    # (it shares the reloaded sources' frame object, as the reference
    # requires, component.py:247)
    resid = np.sum(to_numpy(obs.data) - to_numpy(obs.render(
        blend2.get_model())), axis=0)
    py, px = np.unravel_index(np.argmax(resid), resid.shape)
    frame2 = sources2[0].frame
    new_src = st.CompactExtendedSource(frame2, (float(py), float(px)), obs)
    sources2 = list(sources2) + [new_src]
    blend2 = st.Blend(sources2, obs)
    it2, logL2 = blend2.fit(3 * max_iter, e_rel=1e-4)
    print(f"refit with added source at ({py}, {px}): "
          f"logL {-blend2.loss[0]:.1f} -> {logL2:.1f} in {it2} iterations")
    # the new source starts from the data (the reference's convention);
    # the JAX script's check, kept as it is: where logL > 0 the loss is
    # negative and the check holds whatever the refit does
    assert blend2.loss[-1] < blend2.loss[0] / 20, "refit failed to recover"
    if not fast:
        assert logL2 >= logL - 1e-3, \
            "converged refit with an extra source degraded the fit"
    r.lap("fit")
    return r.result(
        iterations=int(it), logL=[float(blend.log_likelihood[0]),
                                  float(logL)],
        fluxes=[np.asarray(f).tolist() for f in fluxes],
        sources=len(sources), skipped=list(skipped),
        added_at=[int(py), int(px)], refit_iterations=int(it2),
        refit_logL=[float(-blend2.loss[0]), float(logL2)])


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
