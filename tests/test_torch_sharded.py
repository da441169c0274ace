"""The port's sharded fit (``parallel.fit_batch_sharded``, ``make_mesh``,
``shard_batch`` and the engine's band axis) at world size 2 on the CPU:
two processes over gloo, spawned once for all cases.

The blend is ``__graft_entry__``'s demo blend at C = 4, replicated to B =
4 blends whose images are scaled apart (so that a wrong blend order
shows), with ``mono_n_iters`` 16 (a multiple of the port's 4-pass block,
where JAX's plain branch and the port agree).  Each case is held against
the JAX package's ``fit_batch_sharded`` on ``make_mesh(2, bands=...)`` of
the virtual CPU devices and against the unsharded port fit, to the JAX
test's limits (tests/test_parallel.py:166-174): losses rtol 1e-5; SEDs
and morphologies rtol 1e-4, atol 1e-6.  The FISTA case and the adaprox
band case between them reach every band-sum site of the engine: the
threshold cut, logL, the morphology gradients, FISTA's morphology step
norm and the SED step's mean.

The worker imports no JAX: the JAX side runs in the test process.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from numpy.testing import assert_allclose, assert_array_equal

N_ITER = 5
B = 4
SCALES = np.asarray([0.8, 0.93, 1.07, 1.2], np.float32)
LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-6

# case: (mesh shape (blends, bands), shard_bands, variant of the batch)
CASES = {
    "blends": ((2, 1), False, "adaprox"),
    "bands": ((1, 2), True, "adaprox"),
    "bands_unsplit": ((1, 2), False, "adaprox"),
    "scene_mask": ((1, 2), True, "scene_mask"),
    "fista_bands": ((1, 2), True, "fista"),
}


def _worker(rank, world, store, out_dir, batches):
    """One rank: every case of CASES, then shard_batch's slices and the
    error for channels that do not split; results to ``out_dir``."""
    from scarlet_tpu_torch import parallel

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {}
        for name, (shape, shard_bands, variant) in CASES.items():
            cfg, data, state = batches[variant]
            mesh = parallel.make_mesh(bands=shape[1], device_type="cpu")
            out, losses = parallel.fit_batch_sharded(
                state, data, cfg, N_ITER, mesh, shard_bands=shard_bands)
            res[name] = dict(losses=losses, seds=out.seds[0],
                             morphs=out.morphs[0], it=out.it,
                             sed_opt=tuple(out.sed_opt[0]),
                             morph_opt=tuple(out.morph_opt[0]))
        cfg, data, state = batches["adaprox"]
        mesh = parallel.make_mesh(bands=1, device_type="cpu")
        d, s = parallel.shard_batch(data, state, mesh)
        res["shard_batch"] = dict(
            images=d.images, kernel=d.kernel_rfft, seds=s.seds[0],
            it=s.it, mono_weights=d.mono_weights[0],
            shares_tables=d.mono_weights[0].data_ptr()
            == data.mono_weights[0].data_ptr())
        odd = dataclasses.replace(cfg, scene_shape=(3,)
                                  + tuple(cfg.scene_shape[1:]))
        try:
            parallel.fit_batch_sharded(
                state, data, odd, 1,
                parallel.make_mesh(bands=2, device_type="cpu"),
                shard_bands=True)
        except ValueError as e:
            res["odd_channels"] = str(e)
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_batch(variant):
    """The JAX package's (config, data, state) of one batch variant."""
    import jax.numpy as jnp
    import __graft_entry__ as graft
    from scarlet_tpu import optim as jopt
    from scarlet_tpu import parallel as jpar

    config, data, state = graft._demo_setup(C=4)
    config = dataclasses.replace(config, mono_n_iters=(16,))
    K = config.bucket_counts[0]
    if variant == "fista":
        config = dataclasses.replace(config, optimizer="fista")
        data = data._replace(fista_step=(jnp.full((K,), 0.5, jnp.float32),))
        state = state._replace(
            sed_opt=tuple(jopt.FistaState(x, jnp.ones((K,), jnp.float32))
                          for x in state.seds),
            morph_opt=tuple(jopt.FistaState(x, jnp.ones((K,), jnp.float32))
                            for x in state.morphs))
    data, state = jpar.replicate_blend(data, state, B)
    data = data._replace(images=data.images * SCALES[:, None, None, None])
    if variant == "scene_mask":
        _, H, W = config.scene_shape
        m = np.ones((B, H, W), np.float32)
        m[:, :, -5:] = 0.0
        m[1, :4] = 0.0
        data = data._replace(scene_mask=jnp.asarray(m))
    return config, data, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the two gloo ranks, the JAX package's sharded fits
    and the unsharded port fits of the same batches."""
    import jax
    from scarlet_tpu import parallel as jpar
    from scarlet_tpu_torch import convert
    from scarlet_tpu_torch import parallel as tpar

    jax_batches = {v: _jax_batch(v)
                   for v in ("adaprox", "scene_mask", "fista")}
    batches = {v: convert.from_jax(dataclasses.asdict(c),
                                   jax.device_get(d), jax.device_get(s),
                                   device="cpu")
               for v, (c, d, s) in jax_batches.items()}
    out_dir = tmp_path_factory.mktemp("sharded")
    # the two ranks run while this process fits the references
    ranks_ctx = mp.start_processes(
        _worker, args=(2, str(out_dir / "store"), str(out_dir), batches),
        nprocs=2, join=False, start_method="spawn")
    try:
        jax_runs, port_runs = {}, {}
        for name, (shape, shard_bands, variant) in CASES.items():
            config, data, state = jax_batches[variant]
            jax_runs[name] = jax.block_until_ready(jpar.fit_batch_sharded(
                state, data, config, N_ITER,
                jpar.make_mesh(2, bands=shape[1]), shard_bands=shard_bands))
        for variant, (cfg, d, s) in batches.items():
            port_runs[variant] = tpar.fit_batch(s, d, cfg, N_ITER)
    finally:
        while not ranks_ctx.join():
            pass
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in range(2)]
    return dict(ranks=ranks, jax=jax_runs, port=port_runs, batches=batches)


def _close(a, b, rtol, atol=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_fit_matches_jax_and_unsharded(runs, name):
    shape, shard_bands, variant = CASES[name]
    j_state, j_losses = runs["jax"][name]
    u_state, u_losses = runs["port"][variant]
    for res in runs["ranks"]:
        r = res[name]
        assert r["losses"].shape == (N_ITER, B)
        for ref_losses, ref in ((j_losses, j_state), (u_losses, u_state)):
            _close(r["losses"], ref_losses, LOSS_RTOL)
            _close(r["seds"], ref.seds[0], STATE_RTOL, STATE_ATOL)
            _close(r["morphs"], ref.morphs[0], STATE_RTOL, STATE_ATOL)
            assert_array_equal(r["it"].numpy(), np.asarray(ref.it))
        for a, b in zip(r["sed_opt"], u_state.sed_opt[0]):
            _close(a, b, STATE_RTOL, STATE_ATOL)
        for a, b in zip(r["morph_opt"], u_state.morph_opt[0]):
            _close(a, b, STATE_RTOL, STATE_ATOL)
    # every rank returns the same global result
    for key in ("losses", "seds", "morphs"):
        assert torch.equal(runs["ranks"][0][name][key],
                           runs["ranks"][1][name][key])


def test_shard_batch_gives_each_rank_its_blends(runs):
    _, data, state = runs["batches"]["adaprox"]
    for rank, res in enumerate(runs["ranks"]):
        r = res["shard_batch"]
        part = slice(2 * rank, 2 * rank + 2)
        assert torch.equal(r["images"], data.images[part])
        assert torch.equal(r["kernel"], data.kernel_rfft[part])
        assert torch.equal(r["seds"], state.seds[0][part])
        assert torch.equal(r["it"], state.it[part])
        # the shared monotonicity tables go whole to every rank
        assert torch.equal(r["mono_weights"], data.mono_weights[0])
        assert r["shares_tables"]


def test_channels_that_do_not_split_raise(runs):
    for res in runs["ranks"]:
        assert res["odd_channels"] == ("channel count 3 not divisible by "
                                       "bands=2")


def test_make_mesh_needs_a_process_group():
    from scarlet_tpu_torch import parallel

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh(2, device_type="cpu")


def test_make_mesh_without_a_group_is_one_device(runs):
    """Without a process group ``make_mesh()`` is the one-device
    ``LocalMesh`` and starts none: ``shard_batch`` keeps the whole batch
    and ``fit_batch_sharded`` fits it there, bit for bit with
    ``fit_batch`` (the batched example's mesh)."""
    from scarlet_tpu_torch import parallel

    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device_type="cpu")
    assert isinstance(mesh, parallel.LocalMesh) and mesh.size() == 1
    cfg, data, state = runs["batches"]["adaprox"]
    sdata, sstate = parallel.shard_batch(data, state, mesh)
    assert torch.equal(sdata.images, data.images)
    assert torch.equal(sstate.morphs[0], state.morphs[0])
    out, losses = parallel.fit_batch_sharded(state, data, cfg, N_ITER, mesh,
                                             shard_bands=True)
    ref_state, ref_losses = runs["port"]["adaprox"]
    assert_array_equal(losses.numpy(), ref_losses.numpy())
    assert_array_equal(out.morphs[0].numpy(), ref_state.morphs[0].numpy())
    assert_array_equal(out.seds[0].numpy(), ref_state.seds[0].numpy())
    assert not dist.is_initialized()
