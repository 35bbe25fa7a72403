"""Median latency of every request due in the window, from its due time
to its sender holding the answer; a failed request counts as missing."""

from benchmark.metrics_common import percentile


def read(r):
    return percentile(r, 0.50)
