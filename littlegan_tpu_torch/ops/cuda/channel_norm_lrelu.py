"""Per-(sample, channel) instance norm + LeakyReLU over channels-last maps:
the CUDA kernels' wrappers (``csrc/channel_norm_lrelu.cu``), their plain
versions and the autograd Function StarGAN v2's norms run through.

Replaces no TPU kernel: the JAX package has no StarGAN v2. Every norm of
StarGAN v2's generator (IN in each ``ResBlk`` and in ``to_rgb``, AdaIN in
each ``AdainResBlk``) is followed by a LeakyReLU, and :func:`channel_norm_lrelu`
computes both::

    y = leaky_relu((offset + scale) * (x - mean) * rsqrt(var + eps) + shift, alpha)

per sample and channel over H and W (``torch.nn.InstanceNorm2d``'s
arithmetic: the biased variance, eps 1e-5), with f32 statistics and one
rounding, at the output. ``scale`` and ``shift`` are (C,), shared by the
samples (IN's weight and bias), or (B, C), one row per sample (AdaIN's
``gamma`` and ``beta``, with ``offset`` 1). x is (B, C, H, W) in
channels-last memory, and y is too: the kernels read and write NHWC, so the
convolutions around the norm see NHWC tensors and cuDNN transposes none.

What bounds the kernels on the H100 is bytes (``csrc/channel_norm_lrelu.cu``
says how they split the work): a read of x and a write of y forward, reads
of x and dy and a write of dx backward. The backward reads the forward's
per-(sample, channel) f32 mean and rstd, and recomputes the LeakyReLU's
sign from x.

A CPU tensor takes the plain PyTorch versions below, forward and backward,
and so does a CUDA tensor under ``_build.plain_versions()``; a CUDA tensor
launches the kernels, any other device raises. The Function's backward is
first order only (``norm_lrelu.first_order_only``). Counters:
``stargan_v2.channel_norm`` and ``stargan_v2.channel_norm_bwd``, one count
per call of the Function's forward and backward, on either device (25 and,
where the pass is differentiated, 25 per generator pass at 256²).
"""

from __future__ import annotations

from typing import Tuple

import torch

from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda.norm_lrelu import first_order_only, refuse_grad

CALLS = _build.LaunchCounter("stargan_v2.channel_norm")
BWD_CALLS = _build.LaunchCounter("stargan_v2.channel_norm_bwd")

_TILE = 64  # channels of a block
_THREADS = 256
_MIN_ITERS = 2  # pixel rows a thread reads at the least
_BLOCKS_PER_SM = 4  # a launch's blocks: one wave of the kernels' kMinBlocks resident blocks an SM
_sm_count = {}


def _sms(device: torch.device) -> int:
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[device]


def plan(n: int, c: int, p: int, vec: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk): the blocks of a sample's channel tile, and the
    pixels each takes, for n samples of p pixels and c channels, ``vec``
    channels a thread. Enough blocks for ``_BLOCKS_PER_SM`` per SM over the
    launch, each reading at least ``_MIN_ITERS`` rows of pixels a thread."""
    tiles = -(-c // _TILE)
    rows = _THREADS // (_TILE // vec)
    splits = max(1, min(-(-p // (rows * _MIN_ITERS)), -(-sms * _BLOCKS_PER_SM // (n * tiles))))
    chunk = -(-p // splits)
    return -(-p // chunk), chunk


def _rows(t: torch.Tensor, b: int) -> torch.Tensor:
    """A (C,) or (B, C) scale or shift as (B, C) f32."""
    return t.float().expand(b, -1)[:, :, None, None]


def channel_norm_lrelu_plain(x, scale, shift, offset: float, alpha: float, eps: float):
    """(y, mean, rstd): the kernels' forward in PyTorch; mean and rstd (B, C) f32."""
    b = x.shape[0]
    xf = x.float()
    mean = xf.mean((2, 3))
    rstd = torch.rsqrt(xf.var((2, 3), unbiased=False) + eps)
    a = (offset + _rows(scale, b)) * rstd[:, :, None, None]
    z = (xf - mean[:, :, None, None]) * a + _rows(shift, b)
    return torch.where(z > 0, z, alpha * z).to(x.dtype), mean, rstd


def channel_norm_lrelu_bwd_plain(x, dy, scale, shift, offset: float, mean, rstd, alpha: float):
    """(dx, dscale, dshift): the kernels' backward in PyTorch; dscale and
    dshift (B, C) f32, before any sum over a shared (C,) scale's samples."""
    b, p = x.shape[0], x.shape[2] * x.shape[3]
    d = x.float() - mean[:, :, None, None]
    a = (offset + _rows(scale, b)) * rstd[:, :, None, None]
    z = d * a + _rows(shift, b)
    g = dy.float()
    dz = torch.where(z > 0, g, alpha * g)
    n = d * rstd[:, :, None, None]
    dshift, dscale = dz.sum((2, 3)), (dz * n).sum((2, 3))
    dx = a * (dz - dshift[:, :, None, None] / p - n * (dscale[:, :, None, None] / p))
    return dx.to(x.dtype), dscale, dshift


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: expected a (B, C, H, W) tensor in channels-last memory, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if x.shape[0] > 65535:
        raise ValueError(f"{what}: at most 65535 samples, got {x.shape[0]}")


def _affine(scale: torch.Tensor, shift: torch.Tensor, x: torch.Tensor, what: str):
    """(scale, shift, batch stride): f32 on x's device, (C,) (batch stride
    0) or (B, C) with unit channel stride and one batch stride for both."""
    b, c = x.shape[:2]
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32 or t.device != x.device or t.shape not in ((c,), (b, c)):
            raise ValueError(f"{what}: {name} must be float32 ({c},) or ({b}, {c}) on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if scale.shape != shift.shape:
        raise ValueError(f"{what}: scale {tuple(scale.shape)} and shift {tuple(shift.shape)} differ")
    if scale.dim() == 1:
        scale, shift = scale.contiguous(), shift.contiguous()
        return scale, shift, 0
    if scale.stride(1) != 1 or shift.stride() != scale.stride():
        scale, shift = scale.contiguous(), shift.contiguous()
    return scale, shift, scale.stride(0)


def _vec(x: torch.Tensor, *others: torch.Tensor) -> int:
    """Channels a thread takes: a 16-byte vector where every tensor is
    16-byte aligned and C a multiple of the vector, else one."""
    v = 16 // x.element_size()
    ok = x.shape[1] % v == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return v if ok else 1


def channel_norm_lrelu_fwd(x, scale, shift, offset: float, alpha: float, eps: float):
    """(y, mean, rstd) from the kernels: y in x's dtype and channels-last
    memory, mean and rstd (B, C) f32 (what the backward reads)."""
    what = "channel_norm_lrelu"
    refuse_grad(what, "ChannelNormLReLU", x, scale, shift)
    _check(x, what)
    scale, shift, sb = _affine(scale, shift, x, what)
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    vec = _vec(x, y)
    splits, chunk = plan(n, c, h * w, vec, _sms(x.device))
    part = torch.empty((2, n, splits, c), dtype=torch.float32, device=x.device)
    err = _build.lib().lg_channel_norm_lrelu(
        _build.dtype_code(x), int(vec > 1), x.data_ptr(), y.data_ptr(), part.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), sb, offset, mean.data_ptr(), rstd.data_ptr(), n, h * w, c, splits, chunk, alpha, eps,
        _build.stream_ptr(x.device),
    )
    _build.check(err, what)
    return y, mean, rstd


def channel_norm_lrelu_bwd(x, dy, scale, shift, offset: float, mean, rstd, alpha: float):
    """(dx, dscale, dshift) from the kernels: dx in x's dtype and
    channels-last memory, dscale and dshift (B, C) f32. dy is brought to x's
    layout and dtype where it arrives otherwise."""
    what = "channel_norm_lrelu_bwd"
    _check(x, what)
    scale, shift, sb = _affine(scale, shift, x, what)
    dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
    n, c, h, w = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (n, c) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be the forward's contiguous f32 ({n}, {c})")
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dscale = torch.empty((n, c), dtype=torch.float32, device=x.device)
    dshift = torch.empty_like(dscale)
    vec = _vec(x, dy, dx)
    splits, chunk = plan(n, c, h * w, vec, _sms(x.device))
    part = torch.empty((2, n, splits, c), dtype=torch.float32, device=x.device)
    err = _build.lib().lg_channel_norm_lrelu_bwd(
        _build.dtype_code(x), int(vec > 1), x.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), shift.data_ptr(), sb, offset, dscale.data_ptr(),
        dshift.data_ptr(), n, h * w, c, splits, chunk, alpha, _build.stream_ptr(x.device),
    )
    _build.check(err, what)
    return dx, dscale, dshift


class ChannelNormLReLU(torch.autograd.Function):
    """:func:`channel_norm_lrelu_fwd` with :func:`channel_norm_lrelu_bwd` as
    its backward (the plain versions where ``_build.runs_kernel`` says
    no). scale and shift: f32, (C,) or (B, C); a (C,) one's gradient is
    summed over the samples."""

    @staticmethod
    def forward(ctx, x, scale, shift, alpha: float, offset: float, eps: float):
        CALLS.add()
        fwd = channel_norm_lrelu_fwd if _build.runs_kernel(x.device) else channel_norm_lrelu_plain
        y, mean, rstd = fwd(x, scale, shift, offset, alpha, eps)
        ctx.save_for_backward(x, scale, shift, mean, rstd)
        ctx.alpha, ctx.offset = alpha, offset
        return y

    @staticmethod
    @first_order_only
    def backward(ctx, dy):
        BWD_CALLS.add()
        x, scale, shift, mean, rstd = ctx.saved_tensors
        bwd = channel_norm_lrelu_bwd if _build.runs_kernel(x.device) else channel_norm_lrelu_bwd_plain
        dx, dscale, dshift = bwd(x, dy, scale, shift, ctx.offset, mean, rstd, ctx.alpha)
        if scale.dim() == 1:
            dscale, dshift = dscale.sum(0), dshift.sum(0)
        return dx, dscale, dshift, None, None, None


def channel_norm_lrelu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, alpha: float,
                       offset: float = 0.0, eps: float = 1e-5) -> torch.Tensor:
    """``leaky_relu((offset + scale) * IN(x) + shift, alpha)`` of a (B, C, H,
    W) x, IN per (sample, channel) over H and W; scale and shift (C,) or
    (B, C), taken in float32. On a CUDA tensor x must lie in channels-last
    memory; y does."""
    return ChannelNormLReLU.apply(x, scale.float(), shift.float(), alpha, offset, eps)
