"""Share of the traced window (the window and its tail) in which no device
activity ran: 100 x (1 - union of the profiler's CUDA intervals / window)."""


def read(run):
    s = run.summary
    if s is None or s.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
