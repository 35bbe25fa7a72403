"""Convolution primitives with TF SAME padding, on NHWC tensors.

The public functions take the JAX package's layouts (littlegan_tpu/ops/conv.py):
activations NHWC, conv kernels HWIO ``(kh, kw, in, out)``, transposed-conv
kernels ``(kh, kw, out, in)`` (the kernel of the forward conv being
transposed, TF's ``conv2d_transpose`` layout), dense kernels ``(in, out)``.
They permute to PyTorch's NCHW view inside. An NHWC tensor seen through
``permute(0, 3, 1, 2)`` is a channels-last NCHW tensor, so convolutions run
on the NHWC memory without a copy and their outputs come back NHWC.

TF SAME padding is asymmetric for a stride-2 conv on an even input (one
row and column before, two after), so that case pads explicitly; a
stride-2 SAME transposed conv is the full ``conv_transpose2d`` output
cropped by the forward conv's leading pad.

Kernels are stored f32 and cast to the activation dtype at each call, as
in the JAX package; under bf16 the convolutions accumulate in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF SAME (pad_lo, pad_hi) for one spatial axis of a forward conv."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 2
) -> torch.Tensor:
    """SAME-padded strided conv. x: NHWC; kernel: HWIO."""
    kh, kw = kernel.shape[:2]
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    xt = x.permute(0, 3, 1, 2)
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    b = None if bias is None else bias.to(x.dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xt, w, b, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(xt, (pw[0], pw[1], ph[0], ph[1])), w, b, stride=stride)
    return y.permute(0, 2, 3, 1)


def deconv2d(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 2
) -> torch.Tensor:
    """SAME-padded transposed conv with TF semantics: the exact transpose of
    ``conv2d(., kernel, stride)`` on an input ``stride`` times larger.
    x: NHWC; kernel: ``(kh, kw, out, in)``."""
    kh, kw = kernel.shape[:2]
    oh, ow = x.shape[1] * stride, x.shape[2] * stride
    ph = same_pads(oh, kh, stride)
    pw = same_pads(ow, kw, stride)
    # (kh, kw, out, in) -> (in, out, kh, kw): conv_transpose2d's weight layout
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    b = None if bias is None else bias.to(x.dtype)
    xt = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv_transpose2d(xt, w, b, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv_transpose2d(xt, w, b, stride=stride)
        y = y[:, :, ph[0] : ph[0] + oh, pw[0] : pw[0] + ow]
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fully-connected layer. kernel: ``(in, out)``."""
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, kernel.to(x.dtype).t(), b)


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=alpha)
