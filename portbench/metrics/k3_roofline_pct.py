"""K3's (``scene.cu``) share of its bytes bound (``counting.k3_bytes``)
over the device time of its kernels (``scene_kernel``) in the traced
calls."""
from portbench import counting

KERNEL = "scene_kernel"


def read(run):
    w = run.window
    if w.trace is None or w.work is None:
        return None
    us = w.trace.time_us(KERNEL)
    nbytes = counting.k3_bytes(w.work, run.cell.scene)
    return counting.share_pct(counting.bound_s(nbytes), us * 1e-6)
