"""The least time the card could take for StyleGAN3's filtered LeakyReLU
(S6, ``csrc/filtered_lrelu.cu``), worked out from a configuration's layer
schedule (``benchmark/reference/stylegan3.py::schedule``).

A forward launch over a layer's (n, C, Hc, Hc) conv output, Hc the layer's
input size plus 2, its intermediate of T^2 samples and its (n, C, O, O)
output reads the map once and writes the output and the mask (2 bits a
sample) once; its operations are two per nonzero tap of each filter pass
(the up pass down the rows at the input's columns, then along the
columns, Ku / up taps each; the down pass down the rows, then along the
columns, Kd taps each) and two for the activation, per channel. A
backward launch reads the gradient (n, C, O, O), the mask and y, and
writes gy; its passes are the adjoint's (Kd / down taps up, Ku taps down)
with four operations an element of gx for gy and the two column sums.
The bound is the larger of bytes over the card's memory bandwidth and the
operations over its float32 rate (``benchmark/roofline``'s constants).

One iteration runs G forward twice at the batch (Gmain, Dmain) and
backward once (Gmain): every filtered layer's S6 forward twice and its
backward once. Forward launches count on ``stylegan3.filtered_lrelu``,
backward ones on ``stylegan3.filtered_lrelu_bwd``
(``ops/cuda/filtered_lrelu.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.reference.stylegan3 import schedule
from benchmark.roofline import HBM_BYTES_PER_S, ITEM, PEAK_FLOPS

COUNTERS = ("stylegan3.filtered_lrelu", "stylegan3.filtered_lrelu_bwd")
FORWARDS, BACKWARDS = 2, 1  # S6's launches per layer in one iteration


def layers(cfg: dict) -> List[dict]:
    """Each filtered layer's C, Hc (conv output), T (intermediate), O (output), up, Ku, down, Kd."""
    out = []
    for layer in schedule(cfg["image_dim"], cfg["channel_base"], cfg["channel_max"])[1]:
        if layer.torgb:
            continue
        hc = layer.in_size + 2
        ku, kd = len(layer.fu), len(layer.fd)
        t = hc * layer.up + layer.pad[0] + layer.pad[1] - ku + 1
        out.append({"C": layer.cout, "Hc": hc, "T": t, "O": layer.out_size, "up": layer.up, "Ku": ku,
                    "down": layer.down, "Kd": kd, "name": layer.name})
    return out


def launch_cost(layer: dict, n: int, dtype: str, backward: bool) -> Tuple[float, float]:
    """(bytes, operations) of one launch at batch n."""
    c, hc, t, o = layer["C"], layer["Hc"], layer["T"], layer["O"]
    item = ITEM[dtype]
    mask = n * t * t * -(-c // 8) * 2
    if not backward:
        nbytes = n * c * (hc * hc + o * o) * item + mask + 8 * c
        taps_up, taps_down = layer["Ku"] // layer["up"], layer["Kd"]
        ops = 2 * taps_up * t * (hc + t) + 2 * t * t + 2 * taps_down * o * (t + o)
    else:
        nbytes = n * c * (o * o + 2 * hc * hc) * item + mask + 8 * n * c
        taps_up, taps_down = layer["Kd"] // layer["down"], layer["Ku"]
        ops = 2 * taps_up * t * (o + t) + 2 * t * t + 2 * taps_down * hc * (t + hc) + 4 * hc * hc
    return float(nbytes), float(n * c * ops)


def launch_bound_s(layer: dict, n: int, dtype: str, backward: bool) -> float:
    nbytes, ops = launch_cost(layer, n, dtype, backward)
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["float32"])


def iteration_bound(cfg: dict) -> Dict[str, Tuple[float, int]]:
    """Per form (``fwd``, ``bwd``), (bound in seconds, launches) of one iteration."""
    n, dtype = cfg["batch_size"], cfg.get("compute_dtype", "bfloat16")
    ls = layers(cfg)
    fwd = sum(launch_bound_s(x, n, dtype, False) for x in ls)
    bwd = sum(launch_bound_s(x, n, dtype, True) for x in ls)
    return {"fwd": (FORWARDS * fwd, FORWARDS * len(ls)), "bwd": (BACKWARDS * bwd, BACKWARDS * len(ls))}
