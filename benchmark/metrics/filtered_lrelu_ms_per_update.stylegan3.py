"""S6's device ms per iteration in the traced replays: the time of the
kernels named ``filtered_lrelu_kernel`` over the traced iterations, so
that its share of the step can be read beside the step's time. Nothing is
read where S6 did not launch."""


def read(r):
    trace, cfg = r.get("trace"), r.get("config") or {}
    if trace is None or r.get("kind") != "train" or cfg.get("model") != "stylegan3" or not r.get("traced_updates"):
        return None
    device = sum(e - b for b, e, _, name in trace.device if "filtered_lrelu_kernel" in name)
    if device <= 0:
        return None
    return 1e3 * device / r["traced_updates"]
