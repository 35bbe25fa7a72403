"""Set-up: process start to the first timed unit (loading, weights and
data made on the card, the kernels' build, warm-up, the graph's capture)."""


def read(r):
    return r.get("setup_s")
