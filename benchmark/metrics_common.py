"""Arithmetic the metric readers share."""

from __future__ import annotations

import functools
import json
import math


def percentile(r: dict, q: float):
    """The ``q`` quantile of the window's latencies (nearest rank); a
    failed request is +inf, so a tail that reaches one is a miss."""
    lat = r.get("latencies_ms") if r.get("kind") == "serve" else None
    if not lat:
        return None
    s = sorted(lat)
    return s[min(len(s) - 1, int(len(s) * q))]


def category_ms_per_update(r: dict, category: str):
    trace = r.get("trace")
    if trace is None or not trace.device or r.get("kind") != "train" or not r.get("traced_updates"):
        return None
    return 1e3 * trace.by_category().get(category, 0.0) / r["traced_updates"]


def idle_share(r: dict, kind: str):
    trace = r.get("trace")
    if trace is None or r.get("kind") != kind or not trace.window_s or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


@functools.lru_cache(maxsize=8)
def _flops(cfg_json: str) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import littlegan as ref

    cfg = json.loads(cfg_json)
    model = ref.Model.from_config(cfg)
    hp = ref.Hyper.from_config(cfg)
    b, d, c = cfg["batch_size"], cfg["image_dim"], cfg.get("image_channel", 3)
    meta = dict(device="meta")
    p = {k: torch.empty(s, **meta).requires_grad_(True) for k, s in model.shapes().items()}
    img = lambda: torch.empty((b, d, d, c), dtype=torch.uint8, **meta)  # noqa: E731
    cond = lambda: torch.empty((b, model.cond_dim), **meta)  # noqa: E731
    draws = {"noise": torch.empty((b, model.noise_dim), **meta), "flip": torch.empty((b,), dtype=torch.bool, **meta),
             "delta_b": torch.empty((), **meta), "factor": torch.empty((), **meta), "delta_h": torch.empty((), **meta),
             "aug_noise": torch.empty((b, d, d, c), **meta)}
    with FlopCounterMode(display=False) as counter:
        ref.grads_of(p, ref.losses(model, p, img(), cond(), img(), cond(), draws, hp), hp)
    return float(counter.get_total_flops())


def update_flops(cfg: dict) -> float:
    """Operations of one train update of the plain reference (every tap of
    every convolution and matrix product, forward and the three gradients)."""
    out = _flops(json.dumps(cfg, sort_keys=True))
    if not math.isfinite(out) or out <= 0:
        raise ValueError(f"no operations counted for {cfg.get('image_dim')}")
    return out
