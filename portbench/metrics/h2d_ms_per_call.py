"""Device milliseconds of host-to-device copies per traced call (the
upload of layer 1), from the trace."""


def read(run):
    w = run.window
    if w.trace is None or not w.traced_calls:
        return None
    us = w.trace.time_us("HtoD", w.trace.copies)
    return us * 1e-3 / w.traced_calls if us > 0 else None
