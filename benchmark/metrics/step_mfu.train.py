"""The whole update's share of the card's dense bf16 peak, in percent:
the plain reference's operations per update (counted on the meta device,
the same whatever the program does) times the window's updates, over the
window's seconds and 989.4 TFLOP/s."""

from benchmark.metrics_common import update_flops
from benchmark.roofline import PEAK_FLOPS


def read(r):
    if r.get("kind") != "train" or not r.get("window_s") or r.get("device_kind") == "cpu":
        return None
    return 100.0 * update_flops(r["config"]) * r["updates"] / r["window_s"] / PEAK_FLOPS["bfloat16"]
