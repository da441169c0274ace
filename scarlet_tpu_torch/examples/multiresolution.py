"""Multi-resolution joint fit: a high-resolution and a coarser, rotated
observation of one scene fitted with one model (the reference's
multiresolution tutorial flow, with synthetic instruments; the JAX
package's examples/multiresolution.py), first by the object tree's
``Blend.fit`` through a ``ResolutionRenderer``, then batched by
``parallel.MultiResFitter``.

    python -m scarlet_tpu_torch.examples.multiresolution
"""
import numpy as np

import scarlet_tpu_torch as st
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.parallel import MultiResFitter, multires_init
from scarlet_tpu_torch.testing.multires import gaussian_image
from scarlet_tpu_torch.utils import make_tan_wcs
from scarlet_tpu_torch.examples._common import Run, fast_env

CRVAL = (150.0, 2.0)
# three Gaussian blobs: (flux, dx arcsec, dy arcsec, sigma arcsec)
BLOBS = [(100.0, 0.0, 0.0, 0.35), (40.0, 0.9, -0.5, 0.25),
         (25.0, -0.8, 0.7, 0.5)]


def load():
    """Two synthetic instruments observing the blobs: no file; the images,
    PSFs and WCS objects of both."""
    wcs_hr = make_tan_wcs(0.1, (64, 64), crval=CRVAL)
    wcs_lr = make_tan_wcs(0.3, (24, 24), crval=CRVAL,
                          rotation=np.deg2rad(25))

    sig_hr, sig_lr = 0.12, 0.45

    def observed(s):
        return [(f, x, y, np.hypot(w, s)) for f, x, y, w in BLOBS]

    psf_hr = gaussian_image(make_tan_wcs(0.1, (21, 21), crval=CRVAL),
                            (21, 21), [(1, 0, 0, sig_hr)], 0.1)[None]
    psf_lr = gaussian_image(
        make_tan_wcs(0.3, (21, 21), crval=CRVAL, rotation=np.deg2rad(25)),
        (21, 21), [(1, 0, 0, sig_lr)], 0.3)[None]
    return {"data_hr": gaussian_image(wcs_hr, (64, 64), observed(sig_hr),
                                      0.1),
            "data_lr": gaussian_image(wcs_lr, (24, 24), observed(sig_lr),
                                      0.3),
            "psf_hr": psf_hr, "psf_lr": psf_lr,
            "wcs_hr": wcs_hr, "wcs_lr": wcs_lr}


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    data_hr, data_lr = data["data_hr"], data["data_lr"]
    obs_hr = st.Observation(data_hr[None], wcs=data["wcs_hr"],
                            psf=st.ImagePSF(data["psf_hr"]), channels=["hr"],
                            weights=np.full((1, 64, 64), 1e4, np.float32),
                            device=r.device)
    obs_lr = st.Observation(data_lr[None], wcs=data["wcs_lr"],
                            psf=st.ImagePSF(data["psf_lr"]), channels=["lr"],
                            weights=np.full((1, 24, 24), 1e4, np.float32),
                            device=r.device)

    model_frame = st.Frame.from_observations([obs_lr, obs_hr], obs_id=1)
    print(f"model frame: {model_frame.shape}; "
          f"LR renderer: {type(obs_lr.renderer).__name__} "
          f"(rotated={obs_lr.renderer.isrot}, h={obs_lr.renderer.h:.2f})")

    # one source per blob, fitted jointly against both instruments
    sky_coords = []
    for _, bx, by, _ in BLOBS:
        ra = CRVAL[0] + bx / 3600 / np.cos(np.deg2rad(CRVAL[1]))
        dec = CRVAL[1] + by / 3600
        sky_coords.append((ra, dec))

    sources = [st.CompactExtendedSource(model_frame, c, [obs_hr, obs_lr])
               for c in sky_coords]
    r.lap("init")
    blend = st.Blend(sources, [obs_hr, obs_lr])
    max_iter = 10 if fast else 60
    it, logL = blend.fit(max_iter, e_rel=1e-6)
    print(f"joint fit: {it} iterations, logL = {logL:.1f}")

    model = blend.get_model()
    render_lr = to_numpy(obs_lr.render(model))[0]
    sdr = 10 * np.log10(np.sum(data_lr ** 2) ** 0.5
                        / np.sum((data_lr - render_lr) ** 2) ** 0.5)
    print(f"LR render SDR vs data: {sdr:.1f} dB")
    r.lap("fit")

    # the same joint fit, batched: MultiResFitter runs the adaprox loop
    # over a batch of blends sharing this instrument pair, here 3
    # flux-scaled variants fitted against both observations at once
    scales = np.array([1.0, 0.7, 1.5], np.float32)
    d_hr = np.stack([data_hr[None] * s for s in scales])
    d_lr = np.stack([data_lr[None] * s for s in scales])
    w_hr = np.full_like(d_hr, 1e4)
    w_lr = np.full_like(d_lr, 1e4)
    centers = np.tile(np.asarray(
        [np.asarray(model_frame.get_pixel(c), float) for c in sky_coords]
    )[None], (len(scales), 1, 1))

    fitter = MultiResFitter([obs_hr, obs_lr], box_size=31)
    init = multires_init([obs_hr, obs_lr], [d_hr, d_lr], centers,
                         box_size=31, n_slots=3)
    r.lap("init")
    seds, morphs, loss, iters, losses = fitter.fit(
        [d_hr, d_lr], [w_hr, w_lr], *init, n_iter=max_iter * 2)
    flux = (to_numpy(seds).sum(-1)
            * to_numpy(morphs).sum((-2, -1))).sum(-1)
    iters = to_numpy(iters).tolist()
    print(f"batched joint fit ({len(scales)} blends): "
          f"iters {iters}, "
          f"recovered flux ratios {np.round(flux / flux[0], 3).tolist()} "
          f"(true {np.round(scales / scales[0], 3).tolist()})")
    r.lap("fit")
    losses = to_numpy(losses)
    return r.result(iterations=int(it),
                    logL=[float(blend.log_likelihood[0]), float(logL)],
                    sdr=float(sdr), batched_iterations=iters,
                    batched_logL=[float(-losses[0].sum()),
                                  float(-losses[-1].sum())],
                    flux_ratios=(flux / flux[0]).tolist())


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
