"""StyleGAN2's FIR resampling over channels-last maps (S4): the CUDA
kernel's wrapper (``csrc/upfirdn2d.cu``), its plain version and the
autograd Functions.

:func:`upfirdn2d` ``(x, up, down, p0, p1, gain)`` is
``torch_utils/ops/upfirdn2d.py``'s op of NVlabs/stylegan2-ada-pytorch with
its ``setup_filter([1, 3, 3, 1])`` filter (the 4x4 outer product over 64)
and the same padding on both axes: x zero-inserted by ``up``, padded by
``p0`` ahead and ``p1`` after, filtered, times ``gain``, every ``down``-th
pixel kept. ``(up, down)`` is (2, 1), (1, 1) or (1, 2). Its backward is the
same op in the adjoint form (``up`` and ``down`` swapped, ``p0`` ->
``3 - p0``, the input's size), so :class:`UpFirDn2d`'s backward is
:class:`UpFirDn2dBwd` and that one's is :class:`UpFirDn2d` again: gradients
of any order run on the kernel, and the path-length and R1 double
backwards send nothing back into the forward's graph (the backward is a
function of the gradient alone).

Replaces no TPU kernel: the JAX package has no StyleGAN2. What bounds the
kernel is bytes; ``csrc/upfirdn2d.cu`` says how it reads and writes whole
16-byte vectors of channels. A CPU tensor takes the plain version, and so
does a CUDA tensor under ``_build.plain_versions()``; a CUDA tensor
launches the kernel, any other device raises. Counters
``stylegan2.upfirdn2d`` (calls in the forward form: the forward passes, and
a double backward's) and ``stylegan2.upfirdn2d_bwd`` (calls in the adjoint
form), on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from littlegan_tpu_torch.ops.cuda import _build

CALLS = _build.LaunchCounter("stylegan2.upfirdn2d")
BWD_CALLS = _build.LaunchCounter("stylegan2.upfirdn2d_bwd")
TAPS = (1.0, 3.0, 3.0, 1.0)
FORMS = ((2, 1), (1, 1), (1, 2))  # (up, down)


def out_size(n: int, up: int, down: int, p0: int, p1: int) -> int:
    return (n * up + p0 + p1 - len(TAPS)) // down + 1


def upfirdn2d_plain(x: torch.Tensor, up: int, down: int, p0: int, oh: int, ow: int, gain: float) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, as ``_upfirdn2d_ref``: zero
    insertion, padding (``p0`` ahead, what gives (oh, ow) after), a
    depthwise 4x4 conv in float32 (or x's wider dtype), every ``down``-th
    pixel; one rounding at the output."""
    acc = torch.promote_types(x.dtype, torch.float32)
    n, c, h, w = x.shape
    xz = x.to(acc)
    if up > 1:
        xz = torch.zeros((n, c, h * up, w * up), dtype=acc, device=x.device)
        xz[:, :, ::up, ::up] = x.to(acc)
    k = len(TAPS)
    pad_h, pad_w = (oh - 1) * down + k - h * up - p0, (ow - 1) * down + k - w * up - p0
    xz = F.pad(xz, [p0, pad_w, p0, pad_h])
    edge = torch.arange(k, device=x.device) % (k - 1) == 0  # made on the device: no copy inside a graph capture
    f = torch.where(edge, TAPS[0] / sum(TAPS), TAPS[1] / sum(TAPS)).to(acc)
    f = (f[:, None] * f[None, :] * gain).expand(c, 1, k, k)
    y = F.conv2d(xz, f, stride=down, groups=c)
    out = y.to(x.dtype)
    return out.contiguous(memory_format=torch.channels_last) if x.is_contiguous(
        memory_format=torch.channels_last) else out


def upfirdn2d_kernel(x: torch.Tensor, up: int, down: int, p0: int, oh: int, ow: int, gain: float) -> torch.Tensor:
    """The same from the kernel: x a (B, C, H, W) CUDA tensor, float32 or
    bfloat16; the result in x's dtype, in channels-last memory (x is copied
    there first where it lies otherwise: a gradient may arrive in NCHW)."""
    what = "upfirdn2d"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: expected a (B, C, H, W) tensor, got shape {tuple(x.shape)}")
    x = x.contiguous(memory_format=torch.channels_last)
    if (up, down) not in FORMS:
        raise ValueError(f"{what}: (up, down) must be one of {FORMS}, got {(up, down)}")
    n, c, h, w = x.shape
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    v = 16 // x.element_size()
    vec = c % v == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    err = _build.lib().lg_upfirdn2d(_build.dtype_code(x), int(vec), up, down, x.data_ptr(), y.data_ptr(), n, h, w, c,
                                    oh, ow, p0, gain, _build.stream_ptr(x.device))
    _build.check(err, what)
    return y


def _run(x, up, down, p0, oh, ow, gain):
    fn = upfirdn2d_kernel if _build.runs_kernel(x.device) else upfirdn2d_plain
    return fn(x, up, down, p0, oh, ow, gain)


class UpFirDn2d(torch.autograd.Function):
    """The forward form, to an (oh, ow) output; its backward :class:`UpFirDn2dBwd`."""

    @staticmethod
    def forward(ctx, x, up: int, down: int, p0: int, oh: int, ow: int, gain: float):
        CALLS.add()
        ctx.args = up, down, p0, x.shape[2], x.shape[3], gain
        return _run(x, up, down, p0, oh, ow, gain)

    @staticmethod
    def backward(ctx, g):
        up, down, p0, h, w, gain = ctx.args
        return UpFirDn2dBwd.apply(g, down, up, 3 - p0, h, w, gain), None, None, None, None, None, None


class UpFirDn2dBwd(torch.autograd.Function):
    """The adjoint form (called with the adjoint's arguments); its backward :class:`UpFirDn2d`."""

    @staticmethod
    def forward(ctx, g, up: int, down: int, p0: int, oh: int, ow: int, gain: float):
        BWD_CALLS.add()
        ctx.args = up, down, p0, g.shape[2], g.shape[3], gain
        return _run(g, up, down, p0, oh, ow, gain)

    @staticmethod
    def backward(ctx, gg):
        up, down, p0, h, w, gain = ctx.args
        return UpFirDn2d.apply(gg, down, up, 3 - p0, h, w, gain), None, None, None, None, None, None


def upfirdn2d(x: torch.Tensor, up: int, down: int, p0: int, p1: int, gain: float = 1.0) -> torch.Tensor:
    """``upfirdn2d(x, setup_filter([1, 3, 3, 1]), up, down, [p0, p1, p0, p1], gain=gain)`` of a (B, C, H, W) map."""
    return UpFirDn2d.apply(x, up, down, p0, out_size(x.shape[2], up, down, p0, p1),
                           out_size(x.shape[3], up, down, p0, p1), gain)


def upsample2d(x: torch.Tensor) -> torch.Tensor:
    """``upfirdn2d.upsample2d``: x2, gain 4."""
    return upfirdn2d(x, 2, 1, 2, 1, 4.0)


def downsample2d(x: torch.Tensor) -> torch.Tensor:
    """``upfirdn2d.downsample2d``: /2, gain 1."""
    return upfirdn2d(x, 1, 2, 1, 1, 1.0)
