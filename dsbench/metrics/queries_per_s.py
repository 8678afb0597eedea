"""Queries answered inside the window, divided by the window (host clock).

The clients send for ``--seconds``; the window closes at the first answer at
or after that, so the batch answered there counts whole with the time it
took.  A request that failed, or was answered after the window closed, does
not count.
"""


def read(run):
    n = sum(1 for r in run.answered if r.t_done <= run.t_end)
    return n / run.window_s
