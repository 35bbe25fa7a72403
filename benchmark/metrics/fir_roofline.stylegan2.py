"""S4's (``csrc/upfirdn2d.cu``) share of its roofline in the traced
replays, in percent: the bound of its launches there (the mean bound of a
forward-form and of an adjoint-form launch over the lazy period,
``benchmark/roofline/stylegan2.py``, times the launches the two counters
saw) over the device time of the kernels named ``upfirdn2d_kernel``.
Nothing is read where S4 did not launch."""

from benchmark.roofline.stylegan2 import COUNTERS, period_bound


def read(r):
    trace, launched = r.get("trace"), r.get("traced_launches") or {}
    cfg = r.get("config") or {}
    if trace is None or r.get("kind") != "train" or cfg.get("model") != "stylegan2":
        return None
    per = period_bound(cfg)
    bound = sum(per[form][0] / per[form][1] * launched.get(c, 0) for form, c in zip(("fwd", "bwd"), COUNTERS)
                if per[form][1])
    device = sum(e - b for b, e, _, name in trace.device if "upfirdn2d_kernel" in name)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
