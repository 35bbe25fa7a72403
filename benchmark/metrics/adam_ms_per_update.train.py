"""Device ms per update in the trace's "foreach" category (the Adams'
``multi_tensor_apply`` kernels)."""

from benchmark.metrics_common import category_ms_per_update


def read(r):
    return category_ms_per_update(r, "foreach")
