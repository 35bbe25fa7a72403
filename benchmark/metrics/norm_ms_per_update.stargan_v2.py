"""Device ms per iteration of the instance-norm and AdaIN kernels in the
traced replays: the kernels of ``batch_norm`` (which the port's
per-channel instance norm and AdaIN run as) by name, and the port's own
norm kernels (``norm_lrelu*.cu``) by category, so that a fused route still
counts."""

import re

NORM = re.compile(r"batch_norm|instance_norm")
NORM_CATS = ("K1 norm_lrelu.cu", "K2 norm_lrelu_bwd.cu", "K1/K2 norm_lrelu*.cu")


def read(r):
    trace = r.get("trace")
    if trace is None or not trace.device or r.get("kind") != "train" or not r.get("traced_updates"):
        return None
    s = sum(e - b for b, e, cat, name in trace.device if cat in NORM_CATS or NORM.search(name))
    return 1e3 * s / r["traced_updates"] if s > 0 else None
