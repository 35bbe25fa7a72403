"""Device ms per update in the trace's "elementwise" category (copies,
casts, pads, ``where``)."""

from benchmark.metrics_common import category_ms_per_update


def read(r):
    return category_ms_per_update(r, "elementwise")
