"""Convolutions and a LeakyReLU whose backwards are written in
differentiable first-order ops, for the penalties that differentiate a
gradient: StarGAN v2's and StyleGAN2's R1 through the discriminator, and
StyleGAN2's path-length penalty through the generator (the role of
``torch_utils/ops/conv2d_gradfix.py`` in NVlabs/stylegan2-ada-pytorch).

- :class:`R1Conv`: ``conv2d`` without bias (stride 1 or 2). Its backward
  forms the input's gradient as ``conv_transpose2d(g, w)``, a function of
  the gradient and the weight alone, so a double backward runs as that
  transposed conv's first-order backward (cuDNN's data and filter
  gradients). PyTorch's own double backward of a conv takes the weight's
  part as a convolution with a filter the size of the image, and sends a
  gradient of zeros back through the forward's graph.
- :class:`R1ConvTranspose`: its sibling for ``conv_transpose2d`` (stride
  2, no padding; StyleGAN2's upsampling convs), the input's gradient a
  ``conv2d(g, w)``.
- :func:`r1_leaky_relu`: LeakyReLU whose backward, ``where(y > 0, g, alpha
  g)``, is a function of the gradient alone (the sign is a constant).

Inside :func:`no_weight_gradients` their backwards form no weight
gradient: a penalty's first backward, which differentiates with respect to
the images or the latents alone, skips that work (``conv2d_gradfix``'s
context of the same name). The switch is process-wide, as autograd runs a
CUDA backward on its own thread.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_lock = threading.Lock()
_weight_grads_off = 0


@contextlib.contextmanager
def no_weight_gradients():
    """Inside: :class:`R1Conv` and :class:`R1ConvTranspose` return no weight gradient."""
    global _weight_grads_off
    with _lock:
        _weight_grads_off += 1
    try:
        yield
    finally:
        with _lock:
            _weight_grads_off -= 1


def _weight_grad(ctx) -> bool:
    return ctx.needs_input_grad[1] and not _weight_grads_off


class R1Conv(torch.autograd.Function):
    """``conv2d(x, w, stride=stride, padding=padding)`` without bias; the
    input's gradient ``conv_transpose2d(g, w)`` (with the output padding
    that gives x's size back)."""

    @staticmethod
    def forward(ctx, x, w, padding: int, stride: int = 1):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.stride = padding, stride
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p, s = ctx.padding, ctx.stride
        gx = gw = None
        if ctx.needs_input_grad[0]:
            extra = [x.shape[i] - ((g.shape[i] - 1) * s - 2 * p + w.shape[i]) for i in (2, 3)]
            gx = F.conv_transpose2d(g, w, stride=s, padding=p, output_padding=extra if s > 1 else 0)
        if _weight_grad(ctx):
            gw = torch.ops.aten.convolution_backward(g, x, w, None, [s, s], [p, p], [1, 1], False, [0, 0], 1,
                                                     [False, True, False])[1]
        return gx, gw, None, None


class R1ConvTranspose(torch.autograd.Function):
    """``conv_transpose2d(x, w, stride=stride)`` without bias or padding, w
    (in, out, k, k); the input's gradient ``conv2d(g, w, stride=stride)``."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return F.conv_transpose2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        gx = F.conv2d(g, w, stride=s) if ctx.needs_input_grad[0] else None
        gw = None
        if _weight_grad(ctx):
            gw = torch.ops.aten.convolution_backward(g, x, w, None, [s, s], [0, 0], [1, 1], True, [0, 0], 1,
                                                     [False, True, False])[1]
        return gx, gw, None


class _R1LeakyReLU(torch.autograd.Function):
    """LeakyReLU whose backward, ``where(y > 0, g, alpha g)``, is a function
    of the gradient alone (the sign is a constant): its double backward
    sends nothing back into the forward's graph, where PyTorch's sends a
    gradient of zeros."""

    @staticmethod
    def forward(ctx, x, alpha: float):
        y = F.leaky_relu(x, alpha)
        ctx.save_for_backward(y)
        ctx.alpha = alpha
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0, g, g * ctx.alpha), None


def r1_leaky_relu(x, alpha: float):
    return _R1LeakyReLU.apply(x, alpha)
