"""95th percentile of the server's own admission-to-dispatch wait
(``ServeResult.queue_ms``), raw samples over the window's answered
requests."""
from dsbench.yardstick import percentile


def read(run):
    q = [r.queue_ms for r in run.answered]
    return percentile(q, 95) if q else None
