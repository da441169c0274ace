"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: with ``device=None`` and numpy inputs they put their tensors on
the card, or raise where there is none; a tensor argument keeps its own
device; ``device="cpu"`` runs on the host."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scarlet_tpu_torch import convert, lite, models
from scarlet_tpu_torch.device import default_device
from scarlet_tpu_torch.lite import engine
from scarlet_tpu_torch.parallel import stream
from scarlet_tpu_torch.testing import generate_blend

BOX = 21
MODEL_PSF = lite.integrated_circular_gaussian(sigma=0.8)[None].astype(
    np.float32)


@pytest.fixture(scope="module")
def blend():
    return generate_blend(np.random.default_rng(0))


def _stack(d):
    k = len(d["catalog"])
    centers = np.zeros((1, k, 2), np.int32)
    centers[0, :, 0] = np.round(d["catalog"]["y"])
    centers[0, :, 1] = np.round(d["catalog"]["x"])
    return (d["images"][None], d["variance"][None], d["psfs"][None],
            centers)


def _observation(d, **kw):
    w = (1 / d["variance"]).astype(np.float32)
    return lite.LiteObservation(d["images"], d["variance"], w, d["psfs"],
                                model_psf=MODEL_PSF, **kw)


def _config():
    w, keep, n_iter = engine.monotonicity_tables((BOX, BOX))
    return engine.LiteFitConfig(
        scene_shape=(5, 58, 48), box_shapes=((BOX, BOX),),
        bucket_counts=(2,), fft_shape=None, mono_n_iters=(n_iter,))


ENTRY_POINTS = {
    "LiteObservation": lambda d: _observation(d).images,
    "stream_setup": lambda d: stream.stream_setup(
        *_stack(d), MODEL_PSF, box_size=BOX, n_slots=8)[1].images,
    "deblend_device_stream": lambda d: stream.deblend_device_stream(
        *_stack(d), MODEL_PSF, box_size=BOX, n_slots=8, max_iter=2)[1]
    .morphs[0],
    "make_blend_data": lambda d: engine.make_blend_data(
        d["images"], np.ones_like(d["images"]), None,
        np.full(5, 0.1, np.float32), _config()).images,
    "make_blend_state": lambda d: engine.make_blend_state(
        np.ones((2, 5), np.float32), np.ones((2, BOX, BOX), np.float32),
        np.zeros((2, 2), np.int32)).seds[0],
    "Observation": lambda d: models.Observation(
        d["images"], channels=list("grizy")).data,
    "observations_from_jax": lambda d: convert.observations_from_jax(
        [SimpleNamespace(data=d["images"], weights=np.ones_like(d["images"]),
                         channels=list("grizy"), wcs=None, psf=None)])[0]
    .weights,
    "from_jax": lambda d: convert.from_jax(
        dataclasses.asdict(_config()),
        dict(images=d["images"], weights=np.ones_like(d["images"]),
             kernel_rfft=None, grad_kernel_rfft=None,
             bg_rms=np.ones(5, np.float32),
             sed_step_min=np.ones(5, np.float32),
             mono_weights=(np.zeros((9, 8, BOX, BOX), np.float32),),
             mono_keep=(np.zeros((9, BOX, BOX), np.float32),)),
        dict(seds=(np.ones((2, 5), np.float32),),
             morphs=(np.ones((2, BOX, BOX), np.float32),),
             origins=(np.zeros((2, 2), np.int32),),
             comp_active=(np.ones(2, bool),),
             sed_opt=(dict(m=0, v=0, vhat=0),),
             morph_opt=(dict(m=0, v=0, vhat=0),),
             active=True, it=0, last_loss=np.inf))[0].images,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_numpy_inputs_default_to_the_card(blend, name):
    """``device=None`` with numpy inputs: CUDA tensors, or a clear error
    without a card, never CPU tensors."""
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name](blend).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[name](blend)


def test_tensor_inputs_keep_their_device(blend):
    t = {k: torch.from_numpy(blend[k]) for k in ("images", "variance",
                                                  "psfs")}
    obs = lite.LiteObservation(t["images"], t["variance"],
                               1 / t["variance"], t["psfs"],
                               model_psf=MODEL_PSF)
    assert obs.device.type == "cpu"
    state = engine.make_blend_state(torch.ones(2, 5),
                                    torch.ones(2, BOX, BOX),
                                    torch.zeros(2, 2, dtype=torch.int32))
    assert state.seds[0].device.type == state.active.device.type == "cpu"


def test_cpu_on_request(blend):
    obs = _observation(blend, device="cpu")
    assert obs.images.device.type == "cpu"
    _, data, state, _ = stream.stream_setup(
        *_stack(blend), MODEL_PSF, box_size=BOX, n_slots=8, device="cpu")
    assert data.images.device.type == state.morphs[0].device.type == "cpu"


def test_default_device_rule():
    cpu = torch.zeros(1)
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(None, cpu) == torch.device("cpu")
    assert default_device("cpu", np.zeros(1)) == torch.device("cpu")
    if torch.cuda.is_available():
        assert default_device(None, np.zeros(1)).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device(None, np.zeros(1))


def test_multires_fitter_runs_where_its_observations_live():
    """The fitter takes its device from its observations (made on the CPU
    here); numpy stacks given to ``fit`` go there."""
    from scarlet_tpu_torch.parallel import MultiResFitter, multires_init
    from scarlet_tpu_torch.testing import blob_centers, make_pair

    hr, lr, dh, dl = make_pair(device="cpu", shape_hr=(32, 32),
                               shape_lr=(12, 12))
    frame = models.Frame.from_observations([lr, hr], obs_id=1)
    assert hr.data.device.type == lr.renderer.device.type == "cpu"
    fitter = MultiResFitter((hr, lr), box_size=15)
    assert fitter.device.type == "cpu"
    datas = (dh[None, None], dl[None, None])
    weights = tuple(np.ones_like(d) for d in datas)
    init = multires_init((hr, lr), datas, blob_centers(frame, 1),
                         box_size=15, n_slots=3)
    out = fitter.fit(datas, weights, *init, n_iter=2)
    assert all(t.device.type == "cpu" for t in out)
