"""Boundary 3x3 conv with fused per-sample stats: the CUDA kernel's wrapper and its plain version.

Replaces ``littlegan_tpu/ops/pallas/boundary_conv.py::conv3x3_same_stats``:
encoder block1 in space-to-depth form, a 3x3 stride-1 SAME conv plus bias on
a narrow input (12 channels at full width), that also returns each sample's
sum(y) and sum(y^2) taken from the f32 accumulator before the cast to the
output dtype. The instance norm after it reads those instead of making a
stats pass over y (``norm_lrelu.py::norm_lrelu_from_stats``).

What bounds it on the H100 is bytes: at the serve shape (8, 64, 64, 12) ->
64 channels it moves about 5 MB for 0.45 GFLOP. The design
(``csrc/boundary_conv.cu``): a block owns 128 output pixels x all 64
output channels, stages its input rows with a zero halo and the weights in
shared memory as f32, accumulates with a plain FMA loop, writes y with
16-byte stores and one f32 stats partial; a second launch reduces the
partials per sample in a fixed order.

A CPU tensor takes the plain PyTorch version below; a CUDA tensor launches
the kernel or raises. The wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from littlegan_tpu_torch.ops.cuda import _build

_MAX_CIN = 16
_COUTS = (8, 16, 32, 64, 128)  # Cout/8 channel groups must divide 256 threads
_MAX_SMEM = 227 * 1024


def supports(x_shape) -> bool:
    """When the model routes encoder block1 through this kernel (the JAX
    package's predicate without its TPU memory clause): narrow input
    channels and 8-aligned spatial dims."""
    _, h, w, c = x_shape
    return c <= _MAX_CIN and h % 8 == 0 and w % 8 == 0


def conv3x3_same_stats_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in PyTorch: the conv and the sums in f32, y cast to
    x's dtype last; the bias is first rounded to x's dtype, as in the kernel."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.to(x.dtype).float()
    return y.to(x.dtype), y.sum((1, 2, 3)), y.square().sum((1, 2, 3))


def conv3x3_same_stats(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3x3 stride-1 SAME conv + bias, NHWC x HWIO -> (y, s1, s2).

    y is in x's dtype; s1 and s2 are f32 (N,): the sum and the sum of
    squares of each sample's (H, W, Cout) output, bias included."""
    if x.device.type == "cpu":
        return conv3x3_same_stats_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same_stats: expected a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(
            f"conv3x3_same_stats: shapes x {tuple(x.shape)}, w {tuple(w.shape)} are not NHWC x (3,3,Cin,Cout)"
        )
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if cin > _MAX_CIN or cout not in _COUTS or tuple(b.shape) != (cout,):
        raise ValueError(
            f"conv3x3_same_stats: takes Cin <= {_MAX_CIN}, Cout in {_COUTS} and a ({cout},) bias; "
            f"got Cin {cin}, Cout {cout}, bias {tuple(b.shape)}"
        )
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3_same_stats: x, w and b must be on one device")
    if not x.is_contiguous():
        raise ValueError("conv3x3_same_stats: x must be contiguous (NHWC)")
    lib = _build.lib()
    if lib.lg_conv3x3_smem_bytes(wd, cin, cout) > _MAX_SMEM:
        raise ValueError(f"conv3x3_same_stats: width {wd} needs more shared memory than a block has")
    code = _build.dtype_code(x)
    wc = w.to(x.dtype).contiguous()
    bc = b.to(x.dtype).contiguous()
    tiles = lib.lg_conv3x3_tiles(h, wd, cout)
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, n, tiles), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    err = lib.lg_conv3x3_same_stats(
        code, x.data_ptr(), wc.data_ptr(), bc.data_ptr(), y.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        n, h, wd, cin, cout, _build.stream_ptr(x.device),
    )
    _build.check(err, "conv3x3_same_stats")
    conv3x3_same_stats.launches.add()
    return y, stats[0], stats[1]


conv3x3_same_stats.launches = _build.LaunchCounter()
