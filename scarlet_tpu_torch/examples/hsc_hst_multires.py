"""Joint HSC + HST deblending on the reference's cutouts (the
multiresolution tutorial's data, test_resampling/*.fits; the JAX
package's examples/hsc_hst_multires.py) through the batched pipeline:
device detection on the HST image, compact-source init and one joint fit
against both instruments (``parallel.deblend_multires``).

The HSC observation lies on a 3x coarser grid than the HST one, so it
renders through the sinc-resampling ``ResolutionRenderer``; the FITS
headers' WCS is read without astropy (``utils.fits.read_fits``).

    python -m scarlet_tpu_torch.examples.hsc_hst_multires
"""
import numpy as np

import scarlet_tpu_torch as st
from scarlet_tpu_torch.lite.utils import to_numpy
from scarlet_tpu_torch.parallel import deblend_multires
from scarlet_tpu_torch.utils.fits import read_fits
from scarlet_tpu_torch.examples._common import Run, data_path, fast_env


def load():
    """The four cutouts: ``hsc``, ``hst``, ``psf_hsc``, ``psf_hst`` and the
    two images' WCS objects."""
    hsc, _, wcs_hsc = read_fits(data_path("test_resampling/Cut_HSC.fits"))
    hst, _, wcs_hst = read_fits(data_path("test_resampling/Cut_HST.fits"))
    psf_hsc, _, _ = read_fits(data_path("test_resampling/PSF_HSC.fits"))
    psf_hst, _, _ = read_fits(data_path("test_resampling/PSF_HST.fits"))
    return {"hsc": hsc, "wcs_hsc": wcs_hsc, "hst": hst, "wcs_hst": wcs_hst,
            "psf_hsc": psf_hsc, "psf_hst": psf_hst}


def run(data, out_dir=".", fast=False, device=None):
    r = Run(out_dir, device)
    hsc, hst = data["hsc"], data["hst"]
    obs_hsc = st.Observation(hsc, wcs=data["wcs_hsc"],
                             psf=st.ImagePSF(data["psf_hsc"]),
                             channels=["g", "r", "i", "z", "y"],
                             device=r.device)
    obs_hst = st.Observation(hst[None], wcs=data["wcs_hst"],
                             psf=st.ImagePSF(data["psf_hst"][None]),
                             channels=["F814W"], device=r.device)
    frame = st.Frame.from_observations([obs_hsc, obs_hst],
                                       coverage="intersection")
    print(f"model frame {frame.shape}; HSC renders through "
          f"{type(obs_hsc.renderer).__name__} "
          f"(rotated={obs_hsc.renderer.isrot})")

    # a batch of 2: the cutout and a copy 20% brighter (standing in for a
    # stream of cutouts from the same survey pair)
    B = 2
    d_hst = np.stack([np.asarray(hst, np.float32)[None] * (1 + 0.2 * b)
                      for b in range(B)])
    d_hsc = np.stack([np.asarray(hsc, np.float32) * (1 + 0.2 * b)
                      for b in range(B)])
    r.lap("init")

    records, seds, morphs, origins, active, losses = deblend_multires(
        (obs_hst, obs_hsc), (d_hst, d_hsc), centers=None, box_size=61,
        n_slots=12, detect_obs=0, n_iter=10 if fast else 60)

    act = to_numpy(active)
    for b, rec in enumerate(records):
        print(f"blend {b}: {int(act[b].sum())} sources detected on the "
              f"HST image, {rec['iterations']} iterations, "
              f"logL {rec['logL']:.0f}")
    flux = to_numpy(records[0]["flux"]).sum(-1)
    print("brightest sources (total flux):",
          np.sort(flux)[::-1][:5].round(1).tolist())
    losses = to_numpy(losses)
    assert np.all(np.isfinite(losses))
    assert np.all(losses[-1] < losses[0])
    # the brighter copy fits to a proportionally brighter model
    f0 = to_numpy(records[0]["flux"]).sum()
    f1 = to_numpy(records[1]["flux"]).sum()
    print(f"flux ratio blend1/blend0: {f1 / f0:.3f} (true 1.2)")
    print("OK")
    r.lap("fit")
    return r.result(detected=act.sum(axis=1).tolist(),
                    iterations=[int(x["iterations"]) for x in records],
                    logL=[float(-losses[0].sum()), float(-losses[-1].sum())],
                    records_logL=[float(x["logL"]) for x in records],
                    flux_ratio=float(f1 / f0))


def main():
    run(load(), fast=fast_env())


if __name__ == "__main__":
    main()
