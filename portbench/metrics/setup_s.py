"""Seconds from the process' start to the window's start: imports, the
kernels' library (built with nvcc on a checkout's first run), the pool,
and one warm-up call of each distinct call of the window (host clock)."""


def read(run):
    return run.setup_s
