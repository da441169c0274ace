"""100 minus the device's busy share of the traced calls' span: the union
of the device operations' intervals (``trace.busy_us``) over the span
from the first traced call's start to the last one's end."""


def read(run):
    w = run.window
    if w.trace is None or w.traced_span_s <= 0:
        return None
    return 100.0 * (1.0 - w.traced_busy_s / w.traced_span_s)
