"""Host spans around the calls into each layer of the stream, recorded from
the benchmark's side in a traced run only: each named function of the
program's modules is wrapped, while the block runs, in a
``torch.profiler.record_function`` range called ``layer:<name>``.  The
breakdown names an idle gap of the device by the innermost of these that
covers it.  A function that a module no longer has is left out."""
from __future__ import annotations

import contextlib
import functools
import importlib

# (module, function, span): the calls that ``deblend_device_stream`` makes
# through its module's globals
LAYER_SPANS = (
    ("scarlet_tpu_torch.parallel.stream", "_upload", "layer:upload"),
    ("scarlet_tpu_torch.parallel.stream", "stream_setup",
     "layer:stream_setup"),
    ("scarlet_tpu_torch.parallel.stream", "detect_peaks_device",
     "layer:detection"),
    ("scarlet_tpu_torch.parallel.stream", "fit_batch_device_dispatch",
     "layer:fit"),
    ("scarlet_tpu_torch.parallel.stream", "fit_batch_device_converged",
     "layer:fit"),
    ("scarlet_tpu_torch.parallel.stream", "_collect_compacted",
     "layer:compaction"),
    ("scarlet_tpu_torch.parallel.stream", "stream_records", "layer:records"),
    ("scarlet_tpu_torch.parallel.stream", "_retry_overflow",
     "layer:overflow_retry"),
)


def _spanned(fn, name):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def layer_spans(spans=LAYER_SPANS):
    """Within the block, the functions of ``spans`` record their spans."""
    saved = []
    try:
        for module, attr, name in spans:
            mod = importlib.import_module(module)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            saved.append((mod, attr, fn))
            setattr(mod, attr, _spanned(fn, name))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
