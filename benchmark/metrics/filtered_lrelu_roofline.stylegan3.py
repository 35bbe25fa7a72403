"""S6's (``csrc/filtered_lrelu.cu``) share of its roofline in the traced
replays, in percent: the bound of its launches there (the mean bound of a
forward and of a backward launch over an iteration,
``benchmark/roofline/stylegan3.py``, times the launches the two counters
saw) over the device time of the kernels named ``filtered_lrelu_kernel``.
Nothing is read where S6 did not launch (a program without it)."""


def read(r):
    trace, launched = r.get("trace"), r.get("traced_launches") or {}
    cfg = r.get("config") or {}
    if trace is None or r.get("kind") != "train" or cfg.get("model") != "stylegan3":
        return None
    from benchmark.roofline.stylegan3 import COUNTERS, iteration_bound

    per = iteration_bound(cfg)
    bound = sum(per[form][0] / per[form][1] * launched.get(c, 0) for form, c in zip(("fwd", "bwd"), COUNTERS)
                if per[form][1])
    device = sum(e - b for b, e, _, name in trace.device if "filtered_lrelu_kernel" in name)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
