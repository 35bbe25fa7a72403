"""The least time the card could take for the program's hand-written
kernels, worked out from a configuration's layer shapes.

Each kernel family's bytes count every input it needs read once and every
output written once; its operations are the arithmetic its math needs per
element. The bound of one launch is the larger of bytes over the card's
memory bandwidth and operations over its peak rate (NVIDIA's H100 SXM data
sheet, dense, no sparsity). The families and what each launch moves:

- ``K1``, the fused instance norm + LeakyReLU forward: x read, y written,
  each sample's (mean, std) written, gamma and beta read; 7 operations per
  element.
- ``K1p``, the same applied from a boundary conv's sums: y read and
  written, the two sums read, gamma and beta; 4 per element.
- ``K3``, the boundary 3x3 conv in block layout with its per-sample sums:
  x, the kernel and the f32 bias read, y and two f32 sums written; a
  multiply-add per tap, plus 3 per output for the bias and the two sums.
- ``K2``, K1's backward: x and dy read, dx written, the moments read,
  gamma and beta read, their gradients written; 14 per element.
- ``K1p_bwd``, K1p's backward: y and dout read, dy written, the two sums
  and their gradients, gamma, beta and theirs; 12 per element.
- ``fold``, the boundary conv's backward fold: y and gy read, the folded
  gradient written, the sums' cotangents read, the f32 bias gradient
  written; 4 per element.

One train update runs the encoder four times (D on the real batch, D on
the generated batch, the adjuster's encoder on both batches stacked, D on
the adjusted images) and the decoder twice (G on one batch, the adjuster
on two), then takes three gradients: the discriminator's loss through D
on the real and the generated batch, the generator's loss through D on
the generated batch and G, the adjuster's loss through D on the adjusted
images and the adjuster's decoder.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 67e12}
ITEM = {"bfloat16": 2, "float32": 4}

Shape = Tuple[int, int, int, int]
FAMILIES = ("K1", "K1p", "K3", "K2", "K1p_bwd", "fold")
# the port's launch counters (ops/cuda/_build.py) of each family
COUNTER = {"K1": "fused_instance_norm_lrelu", "K1p": "norm_lrelu_from_stats", "K3": "conv3x3_same_stats",
           "K2": "fused_instance_norm_lrelu_bwd", "K1p_bwd": "norm_lrelu_from_stats_bwd", "fold": "conv3x3_bwd_fold"}


def numel(shape: Shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """Seconds: bytes over bandwidth or operations over peak, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def launch_cost(family: str, shape: Shape, dtype: str, cin: int = 0) -> Tuple[float, float]:
    """(bytes, operations) of one launch. ``shape``: the norm's map (K1,
    K2), the conv's output y (K1p, K3, K1p_bwd, fold); ``cin``: K3's input
    channels."""
    item = ITEM[dtype]
    n, el = shape[0], numel(shape)
    if family == "K1":
        return 2 * el * item + 8 * n + 8, 7 * el
    if family == "K1p":
        return 2 * el * item + 8 * n + 8, 4 * el
    if family == "K2":
        return 3 * el * item + 8 * n + 16, 14 * el
    if family == "K1p_bwd":
        return 3 * el * item + 16 * n + 16, 12 * el
    if family == "fold":
        return 3 * el * item + 8 * n + 4 * shape[3], 4 * el
    if family == "K3":
        cout = shape[3]
        x = n * shape[1] * shape[2] * cin
        w = 9 * cin * cout
        return (x + w + el) * item + 4 * cout + 8 * n, 2 * el * 9 * cin + 3 * el
    raise KeyError(family)


def update_launches(cfg: dict) -> Dict[str, List[Tuple[Shape, int]]]:
    """Per family, (shape, launches) of one train update of ``cfg`` (a
    configuration file's dict) with both kernel flags on and the
    space-to-depth boundary."""
    b, d, cf = cfg["batch_size"], cfg["image_dim"], cfg["conv_filter"]
    init = cfg["init_dim"]
    adj = cfg.get("train_adj", True)
    enc = [(d // 4, cf[2]), (d // 8, cf[1]), (d // 16, cf[0])]  # encoder blocks 2-4: (side, channels)
    dec = [(2 * init, cf[1]), (4 * init, cf[2]), (8 * init, cf[3]), (8 * init, 4 * cf[4])]  # block 4 in block layout
    blk1 = (d // 2, cf[3])  # encoder block 1's output, in block layout
    # (rows, forward passes, backward passes) of the encoder and the decoder
    enc_passes = [(b, 1, 1), (b, 1, 2)] + ([(2 * b, 1, 0), (2 * b, 1, 1)] if adj else [])
    dec_passes = [(b, 1, 1)] + ([(2 * b, 1, 1)] if adj else [])
    out: Dict[str, Dict[Shape, int]] = {f: {} for f in FAMILIES}

    def add(family, shape, k):
        if k:
            out[family][shape] = out[family].get(shape, 0) + k

    for rows, fwd, bwd in enc_passes:
        add("K3", (rows, blk1[0], blk1[0], blk1[1]), fwd)
        add("K1p", (rows, blk1[0], blk1[0], blk1[1]), fwd)
        add("K1p_bwd", (rows, blk1[0], blk1[0], blk1[1]), bwd)
        add("fold", (rows, blk1[0], blk1[0], blk1[1]), bwd)
        for side, ch in enc:
            add("K1", (rows, side, side, ch), fwd)
            add("K2", (rows, side, side, ch), bwd)
    for rows, fwd, bwd in dec_passes:
        for side, ch in dec:
            add("K1", (rows, side, side, ch), fwd)
            add("K2", (rows, side, side, ch), bwd)
    return {f: sorted(v.items()) for f, v in out.items()}


def update_bound_s(cfg: dict) -> Dict[str, float]:
    """Per family, the bound in seconds of its launches in one train update."""
    dtype = cfg.get("compute_dtype", "bfloat16")
    cin = 4 * cfg.get("image_channel", 3)  # block layout: 2x2 pixels stacked
    out = {}
    for family, launches in update_launches(cfg).items():
        out[family] = sum(k * bound_s(*launch_cost(family, shape, dtype, cin), dtype) for shape, k in launches)
    return out
