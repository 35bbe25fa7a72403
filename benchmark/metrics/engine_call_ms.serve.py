"""Host wall ms of one ``InferenceEngine`` call (the harness's span
around it), the median over the window's calls."""

import statistics


def read(r):
    calls = r.get("engine_call_s") if r.get("kind") == "serve" else None
    return 1e3 * statistics.median(calls) if calls else None
