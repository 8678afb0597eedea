"""Median latency, submit to answer on the benchmark's clock, over every
request sent in the window; one that failed or never came counts as
infinitely late."""
from dsbench.yardstick import percentile


def read(run):
    return percentile([r.latency_ms for r in run.records], 50)
