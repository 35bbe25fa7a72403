"""Boundary 3x3 conv with fused per-sample stats: the CUDA kernel's wrapper and its plain version.

Replaces ``littlegan_tpu/ops/pallas/boundary_conv.py::conv3x3_same_stats``:
encoder block1 in space-to-depth form, a 3x3 stride-1 SAME conv plus bias on
a narrow input (12 channels at full width), that also returns each sample's
sum(y) and sum(y^2) taken from the f32 accumulator before the cast to the
output dtype. The instance norm after it reads those instead of making a
stats pass over y (``norm_lrelu.py::norm_lrelu_from_stats``).

What bounds it on the H100 is bytes: at the train shape (64, 64, 64, 12) ->
64 channels in bf16 it moves 40 MB (y is 5/6 of it) for 3.6 GFLOP. The
design (``csrc/boundary_conv.cu``), routed by dtype (:func:`kernel_route`):
bf16 runs an implicit GEMM on the tensor cores (``mma.sync`` m16n8k16, K =
9 taps x Cin padded to 16 in shared memory, a persistent grid over tiles of
128 output pixels, y staged in shared memory and written as 16-byte
vectors); f32 keeps a plain FMA loop, since TF32 would miss its 1e-5
tolerance. Each block writes one f32 stats partial per tile and a second
launch reduces the partials per sample in a fixed order.

:class:`BoundaryConvS2D` is the autograd Function the model calls, the
counterpart of the JAX package's custom VJP ``boundary_conv_s2d``. Its
backward folds the stats' cotangents into the output cotangent and sums it
for the bias in one kernel (``conv3x3_bwd_fold``, ``csrc/boundary_conv_bwd.cu``),
then takes dx and dw with PyTorch's convolution backward, as the JAX
package leaves those two to XLA. The backward is first order only: a gradient
of its gradient raises.

A CPU tensor takes the plain PyTorch versions below; a CUDA tensor launches
the kernels or raises, and a raw wrapper asked for a result autograd would
have to differentiate raises. Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda.norm_lrelu import first_order_only, refuse_grad

_MAX_CIN = 16
_COUTS = (8, 16, 32, 64, 128)  # Cout/8 channel groups must divide 256 threads
_MAX_SMEM = 227 * 1024
_FOLD_BLOCK_PIXELS = 512  # pixels per block of the fold kernel


def supports(x_shape) -> bool:
    """When the model routes encoder block1 through this kernel (the JAX
    package's predicate without its TPU memory clause): narrow input
    channels and 8-aligned spatial dims."""
    _, h, w, c = x_shape
    return c <= _MAX_CIN and h % 8 == 0 and w % 8 == 0


def kernel_route(dtype: torch.dtype) -> str:
    """Which kernel of ``csrc/boundary_conv.cu`` a CUDA tensor of this dtype
    launches: "mma" (bf16, tensor cores) or "fma" (f32, CUDA cores)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


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
    refuse_grad("conv3x3_same_stats", "BoundaryConvS2D", x, w, b)
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
    code = _build.dtype_code(x)
    lib = _build.lib()
    if lib.lg_conv3x3_smem_bytes(code, wd, cin, cout) > _MAX_SMEM:
        raise ValueError(f"conv3x3_same_stats: width {wd} needs more shared memory than a block has")
    wc = w.to(x.dtype).contiguous()
    bc = b.to(x.dtype).contiguous()
    parts = lib.lg_conv3x3_partials(code, h, wd, cout)
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, n, parts), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    err = lib.lg_conv3x3_same_stats(
        code, x.data_ptr(), wc.data_ptr(), bc.data_ptr(), y.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        n, h, wd, cin, cout, _build.stream_ptr(x.device),
    )
    _build.check(err, "conv3x3_same_stats")
    conv3x3_same_stats.launches.add()
    return y, stats[0], stats[1]


def conv3x3_bwd_fold_plain(
    y: torch.Tensor, gy: torch.Tensor, gs1: torch.Tensor, gs2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gy', db): ``gy' = gy + gs1 + 2 y gs2`` per sample in f32, returned
    in y's dtype, and its f32 sum over (N, H, W) (``boundary_conv.py:183-190``)."""
    g = gy.float() + gs1.float()[:, None, None, None] + 2.0 * y.float() * gs2.float()[:, None, None, None]
    return g.to(y.dtype), g.sum((0, 1, 2))


def conv3x3_bwd_fold(
    y: torch.Tensor, gy: torch.Tensor, gs1: torch.Tensor, gs2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stats-cotangent fold of the boundary conv's backward: y the
    forward's (cast) output, gy its cotangent, gs1/gs2 the (N,) f32
    cotangents of the sums. Returns (gy' in y's dtype, db f32 (Cout,))."""
    if y.device.type == "cpu":
        return conv3x3_bwd_fold_plain(y, gy, gs1, gs2)
    what = "conv3x3_bwd_fold"
    refuse_grad(what, "BoundaryConvS2D", y, gy, gs1, gs2)
    if y.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {y.device}")
    if y.dim() != 4 or not y.is_contiguous():
        raise ValueError(f"{what}: y must be a contiguous NHWC tensor, got {tuple(y.shape)}")
    if gy.shape != y.shape or gy.dtype != y.dtype or gy.device != y.device or not gy.is_contiguous():
        raise ValueError(f"{what}: gy must be contiguous {y.dtype} {tuple(y.shape)} on {y.device}")
    if y.data_ptr() % 16 or gy.data_ptr() % 16:
        raise ValueError(f"{what}: y and gy must be 16-byte aligned (the kernel moves 16-byte vectors)")
    n, h, wd, cout = y.shape
    for name, t in (("gs1", gs1), ("gs2", gs2)):
        if t.shape != (n,) or t.dtype != torch.float32 or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous f32 ({n},) on {y.device}")
    code = _build.dtype_code(y)
    vec = 16 // y.element_size()
    if cout % vec or 256 % (cout // vec) or cout > 256:
        raise ValueError(f"{what}: takes Cout a multiple of {vec} with Cout/{vec} dividing 256, got {cout}")
    pixels = n * h * wd
    blocks = -(-pixels // _FOLD_BLOCK_PIXELS)
    out = torch.empty_like(y)
    part = torch.empty((blocks, cout), dtype=torch.float32, device=y.device)
    db = torch.empty((cout,), dtype=torch.float32, device=y.device)
    err = _build.lib().lg_conv3x3_bwd_fold(
        code, y.data_ptr(), gy.data_ptr(), gs1.data_ptr(), gs2.data_ptr(), out.data_ptr(), part.data_ptr(),
        db.data_ptr(), pixels, h * wd, cout, _FOLD_BLOCK_PIXELS, blocks, _build.stream_ptr(y.device),
    )
    _build.check(err, what)
    conv3x3_bwd_fold.launches.add()
    return out, db


def conv3x3_input_weight_grads(
    x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor, need_dx: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dx NHWC or None when not ``need_dx``, dw HWIO) of the 3x3 stride-1
    SAME conv for the output cotangent gy, by PyTorch's convolution backward
    (the JAX package's are XLA convolutions, ``boundary_conv.py:191-206``)."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        gy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [need_dx, True, False],
    )
    return (dx.permute(0, 2, 3, 1) if need_dx else None), dw.permute(2, 3, 1, 0)


conv3x3_same_stats.launches = _build.LaunchCounter("conv3x3_same_stats")
conv3x3_bwd_fold.launches = _build.LaunchCounter("conv3x3_bwd_fold")


def boundary_conv_s2d_bwd(
    x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, gy: torch.Tensor, gs1: torch.Tensor, gs2: torch.Tensor,
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(dx or None, dw, db f32) of ``conv3x3_same_stats`` from the forward's
    x, w and (cast) y and the cotangents of (y, s1, s2): the fold kernel,
    then PyTorch's convolution backward on the folded cotangent in x's dtype."""
    gyp, db = conv3x3_bwd_fold(y, gy.to(y.dtype).contiguous(), gs1.float().contiguous(), gs2.float().contiguous())
    dx, dw = conv3x3_input_weight_grads(x, w.to(x.dtype), gyp, need_dx)
    return dx, dw, db


class BoundaryConvS2D(torch.autograd.Function):
    """``conv3x3_same_stats`` -> (y, s1, s2) with the JAX custom VJP's
    backward: the stats' cotangents folded into y's, db in the bias's own
    dtype (f32 even when x and w are bf16), dx and dw in x's and w's."""

    @staticmethod
    def forward(ctx, x, w, b):
        y, s1, s2 = conv3x3_same_stats(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.b_dtype = b.dtype
        return y, s1, s2

    @staticmethod
    @first_order_only
    def backward(ctx, gy, gs1, gs2):
        x, w, y = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dx, dw, db = boundary_conv_s2d_bwd(x, w, y, gy, gs1, gs2, need_dx)
        return (dx.to(x.dtype) if need_dx else None), dw.to(w.dtype), db.to(ctx.b_dtype)
