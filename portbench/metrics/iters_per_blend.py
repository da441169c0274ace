"""Mean fit iterations of the window's blends, from their records (the
solver's own count; an overflow retry's blend counts its refit)."""


def read(run):
    w = run.window
    return w.iterations_sum / w.iterations_n if w.iterations_n else None
