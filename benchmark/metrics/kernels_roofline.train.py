"""The program's hand-written kernels' share of their roofline in the
traced replays, in percent: the bound of every launch that ran (from the
configuration's shapes, ``benchmark/roofline``) over the device time of
the port's kernel source files in the trace. Families that did not launch
count neither way; with none, nothing is read."""

from benchmark.roofline import COUNTER, update_bound_s, update_launches
from benchmark.trace import PORT_CATS


def read(r):
    trace, launched = r.get("trace"), r.get("traced_launches") or {}
    if trace is None or r.get("kind") != "train":
        return None
    per_update = update_bound_s(r["config"])
    counts = {f: sum(k for _, k in v) for f, v in update_launches(r["config"]).items()}
    bound = sum(per_update[f] / counts[f] * launched.get(COUNTER[f], 0) for f in per_update if counts[f])
    device = sum(s for c, s in trace.by_category().items() if c in PORT_CATS)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
