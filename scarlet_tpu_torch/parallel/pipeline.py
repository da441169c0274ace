"""Multiprocess host pipeline for production blend streams
(scarlet_tpu/parallel/pipeline.py).

The batched fit on the card runs thousands of blends per minute, but the
host work around it -- per-blend initialization, engine setup and the
write-back after the fit -- is Python, numpy and scipy, one blend at a
time.  This module spreads that work over persistent CPU worker
processes while the main process drives the card:

    workers: raw arrays -> LiteBlend -> (data, state) numpy trees
    main:    stack -> fit_batch_device_converged (card) -> scatter back
    workers: write-back + flux reweighting + measurements -> records

Each worker owns a fixed shard of the stream (blend ``i`` lives in worker
``i % n_workers`` for the whole run), so blend objects never cross
process boundaries, only arrays do.  Workers are spawned with the card
hidden (``CUDA_VISIBLE_DEVICES=""``) and never touch it: they build each
blend's engine setup on the CPU with the fit device's kernel branches
(``engine_setup(device="cpu", platform=...)``).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import time
import traceback

import numpy as np

__all__ = ["BlendPipeline", "deblend_stream", "build_lite_blend"]


def build_lite_blend(blob, min_snr=50, model_psf_sigma=0.8):
    """Canonical worker-side constructor: a dict of raw arrays (``images``,
    ``variance``, ``psfs``, ``centers``, optional ``weights``) -> an
    initialized, parameterized ``LiteBlend`` on the CPU.  Module-level so
    it pickles into pipeline workers; custom pipelines can pass their own
    constructor."""
    from .. import lite

    images = np.asarray(blob["images"], np.float32)
    variance = np.asarray(blob["variance"], np.float32)
    weights = np.asarray(
        blob.get("weights", 1.0 / np.maximum(variance, 1e-12)), np.float32)
    psfs = np.asarray(blob["psfs"], np.float32)
    model_psf = lite.integrated_circular_gaussian(
        sigma=model_psf_sigma)[None].astype(np.float32)
    obs = lite.LiteObservation(images, variance, weights, psfs,
                               model_psf=model_psf, device="cpu")
    centers = [(int(round(y)), int(round(x))) for y, x in blob["centers"]]
    sources = lite.init_all_sources_main(obs, centers, min_snr=min_snr)
    sources = lite.parameterize_sources(sources, obs,
                                        lite.init_adaprox_component)
    return lite.LiteBlend(sources, obs)


# ----------------------------------------------------------------------------
# Worker process: owns a shard of blends, on the CPU
# ----------------------------------------------------------------------------
def _worker_main(conn):
    import torch

    from ..lite import engine
    from ..lite.measure import weight_sources
    from ..lite.utils import to_numpy

    # n workers with torch's default pool (one thread per core each)
    # oversubscribe the host; one thread per worker was faster on the
    # card's host in every measured run (PERF.md)
    torch.set_num_threads(1)
    blends = {}

    def build(payload):
        build_fn, build_kwargs, items = payload
        out = []
        for idx, blob in items:
            blend = build_fn(blob, **build_kwargs)
            blends[idx] = blend
            C, H, W = blend.observation.shape
            sizes = [max(c.bbox.shape[-2], c.bbox.shape[-1])
                     for c in blend.components]
            dk = blend.observation.diff_kernel
            out.append((idx, {
                "shape": (C, H, W),
                "n_comps": len(blend.components),
                "max_size": max(sizes) if sizes else 1,
                "kernel_shape": None if dk is None else
                tuple(dk.image.shape),
            }))
        return out

    def setup(payload):
        layout, e_rel, min_iter, platform, idxs = payload
        out = []
        for idx in idxs:
            config, data, state = blends[idx].engine_setup(
                e_rel, min_iter, scene_shape=layout["scene_shape"],
                box_size=layout["box_size"], n_slots=layout["n_slots"],
                fft_shape=layout["fft_shape"], device="cpu",
                platform=platform)
            out.append((idx, config, engine.map_tree(to_numpy, data),
                        engine.map_tree(to_numpy, state)))
        return out

    def writeback(payload):
        reweight, measure, items = payload
        out = []
        for idx, state_np, losses_np in items:
            blend = blends[idx]
            ran = int(state_np.it) - blend.it
            if losses_np is not None and ran > 0:
                blend.loss.extend(np.asarray(losses_np)[:ran].tolist())
            blend.it = int(state_np.it)
            blend._write_back(state_np)
            if reweight:
                weight_sources(blend)
            record = {
                "iterations": int(blend.it),
                "logL": float(blend.loss[-1]) if blend.loss
                else float("nan"),
                "init logL": float(blend.loss[0]) if blend.loss
                else float("nan"),
                "n_sources": len(blend.sources),
            }
            if measure:
                record["flux"] = [
                    to_numpy(s.flux if getattr(s, "flux", None) is not None
                             else s.get_model()).sum(axis=(-2, -1)).tolist()
                    for s in blend.sources
                ]
            out.append((idx, record))
        return out

    handlers = {"build": build, "setup": setup, "writeback": writeback}
    while True:
        msg = conn.recv()
        if msg is None:
            conn.close()
            return
        cmd, payload = msg
        try:
            conn.send(("ok", handlers[cmd](payload)))
        except Exception as exc:  # surface worker errors to the main process
            conn.send(("err", f"{exc}\n{traceback.format_exc()}"))


class _WorkerPool:
    """Spawned workers with one duplex pipe each; blend ``i`` is owned by
    worker ``i % n``."""

    def __init__(self, n):
        ctx = mp.get_context("spawn")
        self.conns = []
        self.procs = []
        # a child that initializes CUDA can take the card's memory or
        # wedge it: hide the card in the inherited environment, restoring
        # the parent's afterwards
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for _ in range(n):
                parent, child = ctx.Pipe()
                proc = ctx.Process(target=_worker_main,
                                   args=(child,), daemon=True)
                proc.start()
                child.close()
                self.conns.append(parent)
                self.procs.append(proc)
        except BaseException:
            self.close()
            raise
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved

    def scatter(self, cmd, payloads):
        """Send one (cmd, payload) per worker, gather all replies."""
        for conn, payload in zip(self.conns, payloads):
            conn.send((cmd, payload))
        out, errors = [], []
        for conn in self.conns:
            status, result = conn.recv()
            if status != "ok":
                errors.append(result)
            else:
                out.extend(result)
        if errors:
            raise RuntimeError(f"pipeline worker failed: {errors[0]}")
        return out

    def close(self):
        for conn in self.conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        self.conns, self.procs = [], []


# ----------------------------------------------------------------------------
# Main process
# ----------------------------------------------------------------------------
class BlendPipeline:
    """Persistent host pipeline: spawn the worker pool once, then push
    batches of blend blobs through ``run`` -- amortizes worker startup
    (each worker imports torch) across a long stream.

    ``fit_device``: where the batched fit runs (default: the card;
    ``RuntimeError`` without one).
    """

    def __init__(self, n_workers=8, fit_device=None):
        from ..device import default_device

        self.fit_device = default_device(fit_device)
        self.n_workers = n_workers
        self.pool = _WorkerPool(n_workers)

    def close(self):
        self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def run(self, blobs, build_fn, build_kwargs=None, e_rel=1e-4,
            min_iter=1, max_iter=100, check_every=25, reweight=True,
            measure=True):
        """Deblend one batch of raw blend blobs end to end; returns one
        measurement record per blend, in input order.  Wall-clock of the
        phases lands in ``self.last_timings``."""
        import torch

        from ..lite import engine
        from ..ops import fft as fft_ops
        from .batch import fit_batch_device_converged, pack_batch

        timings = {}
        t0 = time.perf_counter()

        def mark(name):
            nonlocal t0
            now = time.perf_counter()
            timings[name] = round(now - t0, 3)
            t0 = now

        build_kwargs = build_kwargs or {}
        platform = self.fit_device.type
        n_workers = self.n_workers
        pool = self.pool

        def shard(items):
            return [[it for i, it in enumerate(items)
                     if i % n_workers == w] for w in range(n_workers)]

        # phase 1: initialize all blends in their workers; learn layouts
        layouts = dict(pool.scatter("build", [
            (build_fn, build_kwargs, part)
            for part in shard(list(enumerate(blobs)))
        ]))

        # common static layout = elementwise maximum over the stream
        C = layouts[0]["shape"][0]
        H = max(v["shape"][1] for v in layouts.values())
        W = max(v["shape"][2] for v in layouts.values())
        cap = max(H, W) + 1
        box = 1
        for v in layouts.values():
            s = min(v["max_size"], cap)
            box = max(box, s + (s % 2 == 0))
        n_slots = max(v["n_comps"] for v in layouts.values())
        fft_shape = None
        for v in layouts.values():
            if v["kernel_shape"] is not None:
                fs = fft_ops.minimal_same_fft_shape(
                    (C, H, W), v["kernel_shape"], axes=(1, 2))
                fft_shape = fs if fft_shape is None else tuple(
                    max(a, b) for a, b in zip(fft_shape, fs))
        layout = {"scene_shape": (C, H, W), "box_size": box,
                  "n_slots": n_slots, "fft_shape": fft_shape}
        mark("init_s")

        # phase 2: per-blend engine trees at the shared layout
        setups, configs = {}, {}
        for idx, cfg, data, state in pool.scatter("setup", [
            (layout, e_rel, min_iter, platform, idxs)
            for idxs in shard(list(range(len(blobs))))
        ]):
            configs[idx] = cfg
            setups[idx] = (engine.map_tree(torch.from_numpy, data),
                           engine.map_tree(torch.from_numpy, state))
        mark("setup_s")
        pad = max(c.scene_pad for c in configs.values())
        config = dataclasses.replace(configs[0], scene_pad=pad)
        for c in configs.values():
            if dataclasses.replace(c, scene_pad=pad) != config:
                raise ValueError(f"incompatible configs: {c} vs {config}")

        # phase 3: stack, one move to the fit device, batched fit, one
        # move back
        data, state = pack_batch([setups[i] for i in range(len(blobs))])
        dev = self.fit_device
        data = engine.map_tree(lambda x: x.to(dev), data)
        state = engine.map_tree(lambda x: x.to(dev), state)
        out, losses = fit_batch_device_converged(
            state, data, config, max_iter, check_every=check_every)
        out = engine.map_tree(lambda x: x.cpu().numpy(), out)
        losses = losses.cpu().numpy()
        mark("fit_s")

        # phase 4: scatter results back for write-back + measurement
        items = [(i, engine.map_tree(lambda x: x[i], out), losses[:, i])
                 for i in range(len(blobs))]
        records = [None] * len(blobs)
        for idx, rec in pool.scatter("writeback", [
            (reweight, measure, part) for part in shard(items)
        ]):
            records[idx] = rec
        mark("writeback_s")
        self.last_timings = timings
        return records


def deblend_stream(blobs, build_fn, build_kwargs=None, e_rel=1e-4,
                   min_iter=1, max_iter=100, check_every=25, n_workers=8,
                   reweight=True, measure=True, fit_device=None):
    """One-shot convenience around :class:`BlendPipeline` (spawns and
    tears down the worker pool; long streams should hold a pipeline)."""
    n_workers = max(1, min(n_workers, len(blobs)))
    with BlendPipeline(n_workers=n_workers, fit_device=fit_device) as pipe:
        return pipe.run(blobs, build_fn, build_kwargs=build_kwargs,
                        e_rel=e_rel, min_iter=min_iter, max_iter=max_iter,
                        check_every=check_every, reweight=reweight,
                        measure=measure)
