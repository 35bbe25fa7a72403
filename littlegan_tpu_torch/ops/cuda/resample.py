"""StarGAN v2's 2x2 resampling over channels-last maps: the CUDA kernel's
wrapper (``csrc/resample.cu``), its plain version and the autograd
Functions.

``down2(x, s)`` is ``s`` times the sum of each 2x2 block (``s`` = 1/4: the
average pool), ``up2(x, s)`` ``s`` times the nearest x2 upsample (``s`` = 1).
Each is the other's adjoint at the same ``s``, so :class:`Down2`'s backward
is :class:`Up2` and :class:`Up2`'s is :class:`Down2`: gradients of any order
run on the kernels, and R1's double backward through the discriminator's
pools sends nothing back into the forward's graph (the backward is a
function of the gradient alone).

Replaces no TPU kernel: the JAX package has no StarGAN v2. What bounds the
kernel is bytes; ``csrc/resample.cu`` says how it reads and writes whole
16-byte vectors of channels. A CPU tensor takes the plain version, and so
does a CUDA tensor under ``_build.plain_versions()``; a CUDA tensor
launches the kernel, any other device raises. Counters
``stargan_v2.down2`` and ``stargan_v2.up2``: one count per call, forward
or backward, on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from littlegan_tpu_torch.ops.cuda import _build

DOWN2 = _build.LaunchCounter("stargan_v2.down2")
UP2 = _build.LaunchCounter("stargan_v2.up2")


def resample2_plain(x: torch.Tensor, s: float, up: bool) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: sums in float32 (or x's wider
    dtype), one rounding at the output."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    y = F.interpolate(xf, scale_factor=2, mode="nearest") if up else F.avg_pool2d(xf, 2) * 4.0
    return (y * s).to(x.dtype)


def resample2(x: torch.Tensor, s: float, up: bool) -> torch.Tensor:
    """``up2(x, s)`` (``up``) or ``down2(x, s)`` of a (B, C, H, W) CUDA
    tensor, float32 or bfloat16, through the kernel; the result, like the
    map the kernel reads, in channels-last memory (x is copied there first
    where it lies otherwise)."""
    what = "resample2"
    if x.dim() != 4:
        raise ValueError(f"{what}: expected a (B, C, H, W) tensor, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if not up and (h % 2 or w % 2):
        raise ValueError(f"{what}: a 2x2 pool needs an even height and width, got {h}x{w}")
    x = x.contiguous(memory_format=torch.channels_last)
    shape = (n, c, 2 * h, 2 * w) if up else (n, c, h // 2, w // 2)
    y = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    v = 16 // x.element_size()
    vec = c % v == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    err = _build.lib().lg_resample2(_build.dtype_code(x), int(vec), int(up), x.data_ptr(), y.data_ptr(), n, h, w, c,
                                    s, _build.stream_ptr(x.device))
    _build.check(err, what)
    return y


def _resample(x: torch.Tensor, s: float, up: bool) -> torch.Tensor:
    (UP2 if up else DOWN2).add()
    if not _build.runs_kernel(x.device):
        return resample2_plain(x, s, up)
    if x.device.type != "cuda":
        raise ValueError(f"resample2: expected a CPU or CUDA tensor, got {x.device}")
    return resample2(x, s, up)


class Down2(torch.autograd.Function):
    """``down2(x, s)``; its backward ``up2(g, s)``, itself differentiable."""

    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return _resample(x, s, False)

    @staticmethod
    def backward(ctx, g):
        return Up2.apply(g, ctx.s), None


class Up2(torch.autograd.Function):
    """``up2(x, s)``; its backward ``down2(g, s)``, itself differentiable."""

    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return _resample(x, s, True)

    @staticmethod
    def backward(ctx, g):
        return Down2.apply(g, ctx.s), None
