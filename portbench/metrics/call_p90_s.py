"""The 90th percentile of the seconds of all calls of the window, each
from the call to its records on the host after a synchronize (host
clock)."""
import numpy as np


def read(run):
    d = run.window.durations
    return float(np.percentile(d, 90)) if d else None
