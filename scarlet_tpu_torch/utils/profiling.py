"""Profiling and timing helpers: a ``torch.profiler`` trace, named
regions on its timeline, and timing synchronized with the card.  Port of
``scarlet_tpu/utils/profiling.py``.

PyTorch returns from a CUDA call before the card has finished it, so
:func:`sync` waits for the card wherever a result holds a CUDA tensor,
and :func:`timeit` times each call up to that wait.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["trace", "annotate", "sync", "timeit"]


@contextlib.contextmanager
def trace(logdir):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    a card, of its kernels into ``logdir`` (TensorBoard's trace format,
    readable by Perfetto).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof


def annotate(name):
    """A named region that shows on the profiler's timeline."""
    return torch.profiler.record_function(name)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree):
    """Wait for the card to finish the work behind the CUDA tensors of
    ``tree`` (nested tuples, lists, dicts and NamedTuples) and return
    ``tree``."""
    devices = {t.device for t in _leaves(tree) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


def timeit(fn, *args, iters=5, warmup=1, **kwargs):
    """Median seconds per call of ``fn(*args, **kwargs)``, each timed up
    to the end of its work on the card (:func:`sync` of its result).  The
    warm-up calls absorb first-use costs (kernel builds, FFT plans)."""
    for _ in range(warmup):
        sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
