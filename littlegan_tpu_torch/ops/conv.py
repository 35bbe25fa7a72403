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
cropped by the forward conv's leading pad. Where a norm kernel writes the
padded map itself or reads the window out of the full output
(``models/littlegan.py``), the model calls :func:`conv2d_padded` and
:func:`deconv2d_full` instead, with :func:`same_border` and
:func:`same_crop` saying where the map lies: no pad, crop or copy.

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


def same_border(h: int, w: int, k: int, stride: int) -> Optional[Tuple[int, int, int, int]]:
    """(top, bottom, left, right): TF SAME's pads of a conv over an h x w
    map where they are uneven, which cuDNN's symmetric padding cannot take
    (a stride-2 conv over an even map); None where they are even."""
    ph, pw = same_pads(h, k, stride), same_pads(w, k, stride)
    return None if ph[0] == ph[1] and pw[0] == pw[1] else (*ph, *pw)


def same_crop(h: int, w: int, k: int, stride: int) -> Optional[Tuple[int, int, int, int]]:
    """(top, left, rows, cols): the window of :func:`deconv2d_full`'s output
    over an h x w input that TF SAME keeps, where the crop is uneven; None
    where it is even (``deconv2d`` pads symmetrically there)."""
    border = same_border(h * stride, w * stride, k, stride)
    return None if border is None else (border[0], border[2], h * stride, w * stride)


def conv2d_padded(
    xp: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 2
) -> torch.Tensor:
    """:func:`conv2d` of a map that already holds its SAME border: ``xp`` is
    the map inside :func:`same_border`'s zeros, taken whole with no padding,
    as ``conv2d`` takes its own ``F.pad``'s output."""
    w = kernel.to(xp.dtype).permute(3, 2, 0, 1)
    b = None if bias is None else bias.to(xp.dtype)
    return F.conv2d(xp.permute(0, 3, 1, 2), w, b, stride=stride).permute(0, 2, 3, 1)


def deconv2d_full(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 2
) -> torch.Tensor:
    """:func:`deconv2d`'s whole ``conv_transpose2d`` output before SAME's
    crop, NHWC; :func:`same_crop` gives the window ``deconv2d`` keeps."""
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    b = None if bias is None else bias.to(x.dtype)
    return F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=stride).permute(0, 2, 3, 1)


def conv2d(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 2,
    pad_h: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """SAME-padded strided conv. x: NHWC; kernel: HWIO. ``pad_h``: H's
    (pad_lo, pad_hi) instead of SAME's (an H-sharded map's rows arrive
    with their halo: ``(0, 0)``)."""
    kh, kw = kernel.shape[:2]
    ph = same_pads(x.shape[1], kh, stride) if pad_h is None else pad_h
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
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 2,
    crop_h: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """SAME-padded transposed conv with TF semantics: the exact transpose of
    ``conv2d(., kernel, stride)`` on an input ``stride`` times larger.
    x: NHWC; kernel: ``(kh, kw, out, in)``. ``crop_h``: (start, rows) of
    the full output's H to keep instead of SAME's (an H-sharded map's rows
    with their halo)."""
    kh, kw = kernel.shape[:2]
    oh, ow = x.shape[1] * stride, x.shape[2] * stride
    ph = same_pads(oh, kh, stride)
    pw = same_pads(ow, kw, stride)
    # (kh, kw, out, in) -> (in, out, kh, kw): conv_transpose2d's weight layout
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    b = None if bias is None else bias.to(x.dtype)
    xt = x.permute(0, 3, 1, 2)
    if crop_h is None and ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv_transpose2d(xt, w, b, stride=stride, padding=(ph[0], pw[0]))
    else:
        h0, hn = (ph[0], oh) if crop_h is None else crop_h
        y = F.conv_transpose2d(xt, w, b, stride=stride)
        y = y[:, :, h0 : h0 + hn, pw[0] : pw[0] + ow]
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fully-connected layer. kernel: ``(in, out)``."""
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, kernel.to(x.dtype).t(), b)


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=alpha)
