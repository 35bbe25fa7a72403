"""The whole iteration's share of the card's dense bf16 peak, in percent:
the plain reference's operations per StyleGAN2 iteration averaged over the
lazy period (counted on the meta device as the published code runs it,
the same whatever the program does) times the window's iterations, over
the window's seconds and 989.4 TFLOP/s."""

from benchmark.reference.stylegan2 import iteration_flops
from benchmark.roofline import PEAK_FLOPS


def read(r):
    cfg = r.get("config") or {}
    if r.get("kind") != "train" or not r.get("window_s") or r.get("device_kind") == "cpu" \
            or cfg.get("model") != "stylegan2":
        return None
    return 100.0 * iteration_flops(cfg) * r["updates"] / r["window_s"] / PEAK_FLOPS["bfloat16"]
