"""K1's (``mono.cu``) share of its bytes bound (``counting.k1_bytes``) over
the device time of its kernels (``mono_kernel``) in the traced calls."""
from portbench import counting

KERNEL = "mono_kernel"


def read(run):
    w = run.window
    if w.trace is None or w.work is None:
        return None
    us = w.trace.time_us(KERNEL)
    launches = w.trace.count(KERNEL)
    nbytes = counting.k1_bytes(w.work, int(run.cell.config["box_size"]),
                               launches)
    return counting.share_pct(counting.bound_s(nbytes), us * 1e-6)
