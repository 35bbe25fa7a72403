"""Share of the traced replays' window in which no device operation ran, in percent."""

from benchmark.metrics_common import idle_share


def read(r):
    return idle_share(r, "train")
