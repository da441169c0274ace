"""K4's (``grad.cu``) share of its bytes bound (``counting.k4_bytes``)
over the device time of its kernels (``grad_kernel``) in the traced
calls."""
from portbench import counting

KERNEL = "grad_kernel"


def read(run):
    w = run.window
    if w.trace is None or w.work is None:
        return None
    us = w.trace.time_us(KERNEL)
    nbytes = counting.k4_bytes(w.work, run.cell.scene,
                               int(run.cell.config["box_size"]))
    return counting.share_pct(counting.bound_s(nbytes), us * 1e-6)
