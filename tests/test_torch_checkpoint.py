"""The port's fit checkpoints (``scarlet_tpu_torch.checkpoint``): a round
trip of the lite engine's config, ``BlendState`` and ``BlendData``, and a
fit resumed from a checkpoint against the same fit run without a stop.

Input: the JAX package's demo blend (``__graft_entry__._demo_setup``)
carried over by ``convert.from_jax``, on the CPU; for FISTA's state, the
port's own ``LiteBlend`` of a generated blend (seed 1) with FISTA
components.

Tolerance: none.  The checkpoint holds every tensor's bits, so the round
trip is equal and the resumed fit gives the uninterrupted fit's losses
and state exactly, as tests/test_checkpoint.py asks of the JAX package
(there to 1e-6).
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import __graft_entry__ as graft
from scarlet_tpu import checkpoint as jckpt
from scarlet_tpu.testing.blendsets import generate_blend
from scarlet_tpu_torch import checkpoint, convert
from scarlet_tpu_torch import lite as tlite
from scarlet_tpu_torch.lite import engine as teng

from test_torch_fista import _blend


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several worker processes
    side by side, and PyTorch's CPU thread pool (one thread per core in
    each) slows by an order of magnitude when they oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(config, data, state):
    return convert.from_jax(dataclasses.asdict(config), jax.device_get(data),
                            jax.device_get(state), device="cpu")


def _leaves(tree):
    out = []
    teng.map_tree(lambda x: out.append(x), tree)
    return out


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    assert type(a) is type(b)
    for x, y in zip(la, lb):
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        assert x.dtype == y.dtype and x.shape == y.shape
        assert_array_equal(x.numpy(), y.numpy())


@pytest.fixture(scope="module")
def setup():
    return _port(*graft._demo_setup())


@pytest.mark.parametrize("optimizer", ["adaprox", "fista"])
def test_round_trip_and_exact_resume(setup, tmp_path, optimizer):
    config, data, state = setup
    if optimizer == "fista":
        d = generate_blend(np.random.default_rng(1))
        config, data, state = _blend(tlite, d, "init_fista_component") \
            .engine_setup()
        assert config.optimizer == "fista"
    state7, losses7 = teng.fit_scan(state, data, config, 7)

    path = checkpoint.save_fit_state(tmp_path / "ckpt", config, state7, data)
    assert path.suffix == ".ckpt"
    config2, state2, data2 = checkpoint.load_fit_state(path, device="cpu")
    assert config2 == config
    _assert_trees_equal(state7, state2)
    _assert_trees_equal(data, data2)

    full_state, full_losses = teng.fit_scan(state, data, config, 12)
    resumed, resumed_losses = teng.fit_scan(state2, data2, config2, 5)
    assert_array_equal(resumed_losses.numpy(), full_losses[7:].numpy())
    _assert_trees_equal(full_state, resumed)


def test_state_without_data(setup, tmp_path):
    config, _, state = setup
    path = checkpoint.save_fit_state(tmp_path / "state", config, state)
    _, state2, data2 = checkpoint.load_fit_state(tmp_path / "state",
                                                 device="cpu")
    assert data2 is None
    _assert_trees_equal(state, state2)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["version"] == 1
    assert all(isinstance(x, np.ndarray) for x in _leaves(payload["state"]))


def test_load_defaults_to_the_card_and_checks_the_version(setup, tmp_path,
                                                          monkeypatch):
    config, _, state = setup
    path = checkpoint.save_fit_state(tmp_path / "c", config, state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_fit_state(path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["version"] = 2
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_fit_state(path, device="cpu")


def test_jax_checkpoint_holds_the_same_state(tmp_path):
    """The JAX package's checkpoint of the same state holds the same
    arrays as the port's (its config is the JAX package's class, which
    the port does not read)."""
    jconfig, jdata, jstate = graft._demo_setup()
    config, data, state = _port(jconfig, jdata, jstate)
    jpath = jckpt.save_fit_state(tmp_path / "j", jconfig, jstate)
    tpath = checkpoint.save_fit_state(tmp_path / "t", config, state)
    with open(jpath, "rb") as f:
        jp = pickle.load(f)
    with open(tpath, "rb") as f:
        tp = pickle.load(f)
    assert jp["version"] == tp["version"] == 1
    assert type(jp["config"]).__module__.startswith("scarlet_tpu.")
    assert type(tp["config"]).__module__.startswith("scarlet_tpu_torch.")
    for j, t in zip(jax.tree.leaves(jp["state"]), _leaves(tp["state"])):
        assert_array_equal(t, np.asarray(j, dtype=t.dtype))
