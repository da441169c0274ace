"""Blends of the calls completed in the window per minute: all of them,
over the time from the window's start to the end of its last call (host
clock; a call ends when its records are on the host)."""


def read(run):
    w = run.window
    if not w.blends or w.end <= w.start:
        return None
    return 60.0 * w.blends / (w.end - w.start)
