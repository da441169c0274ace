"""Device kernels in the trace per traced call (copies and fills left
out)."""


def read(run):
    w = run.window
    if w.trace is None or not w.traced_calls or not w.trace.kernels:
        return None
    return len(w.trace.kernels) / w.traced_calls
