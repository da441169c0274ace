"""The fit's required work over the traced calls' wall time, as a share
of the card's published peaks: the larger of the bytes and the float32
operations bound of ``counting.fit_work`` (every blend's own iterations
at the configuration's shapes), over the traced span."""
from portbench import counting


def read(run):
    w = run.window
    if w.work is None or w.traced_span_s <= 0:
        return None
    C, H, W = run.cell.scene
    nbytes, nops = counting.fit_work(w.work, (C, H, W),
                                     int(run.cell.config["box_size"]),
                                     run.fft_shape)
    return counting.share_pct(counting.bound_s(nbytes, nops),
                              w.traced_span_s)
