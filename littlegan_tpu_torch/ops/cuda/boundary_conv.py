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
launch reduces the partials per sample in a fixed order. Both take any Cout,
as the Pallas kernel does: a block computes a Cout tile of 8, 16, 32, 64 or
128 channels, the channels past Cout zero in shared memory and kept out of
y and the stats (:func:`conv_plan`). Whether a shape fits a block's shared
memory is decided from the shape alone, before any launch: ``supports``
says False where it does not, and the model then runs block1 on the plain
ops, as the JAX model does where its predicate says False.

:class:`BoundaryConvS2D` is the autograd Function the model calls, the
counterpart of the JAX package's custom VJP ``boundary_conv_s2d``. Its
backward folds the stats' cotangents into the output cotangent and sums it
for the bias in one kernel (``conv3x3_bwd_fold``, ``csrc/boundary_conv_bwd.cu``),
then takes dx and dw with PyTorch's convolution backward, as the JAX
package leaves those two to XLA. The backward is first order only: a gradient
of its gradient raises.

A CPU tensor takes the plain PyTorch versions below, and so does a CUDA
tensor under ``_build.plain_versions()``; a CUDA tensor launches the
kernels, any other device raises, and a raw wrapper asked for a result
autograd would have to differentiate raises. Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda.norm_lrelu import first_order_only, refuse_grad

_MAX_CIN = 16
_MAX_SMEM = 227 * 1024
_FOLD_BLOCK_PIXELS = 512  # pixels per block of the fold kernel
# csrc/boundary_conv.cu's geometry, which conv_plan mirrors: the Cout tiles
# a block computes; the bf16 kernel's output pixels per tile and bf16 per
# staged pixel and packed weight row; the f32 kernel's threads, each
# computing _PIX_PER_THREAD pixels x _CH_PER_THREAD channels
_COUT_TILES = (8, 16, 32, 64, 128)
_MMA_PIXELS = 128
_ROW_STRIDE = 24
_THREADS = 256
_PIX_PER_THREAD = 4
_CH_PER_THREAD = 8


class ConvPlan(NamedTuple):
    """How ``csrc/boundary_conv.cu`` runs one shape: ``route`` "mma" (bf16)
    or "fma" (f32); Cout in ``cout_tiles`` tiles of ``cout_tile`` channels;
    the bf16 kernel's staging buffers ``nbuf``; ``smem`` bytes of dynamic
    shared memory per block; ``parts`` stats partials per sample."""

    route: str
    cout_tile: int
    cout_tiles: int
    nbuf: int
    smem: int
    parts: int

    @property
    def fits(self) -> bool:
        """Whether a block's shared memory holds what the plan asks."""
        return self.smem <= _MAX_SMEM


def _staged_rows(pixels: int, wd: int) -> int:
    """Input rows a tile of ``pixels`` flat output pixels touches, halo included."""
    return (pixels // wd if pixels % wd == 0 else (pixels - 1) // wd + 2) + 2


def cout_tiling(cout: int) -> Tuple[int, int]:
    """(tile, tiles): Cout in tiles of at most 128 channels, each the least
    of ``_COUT_TILES`` that holds its share."""
    tiles = -(-cout // _COUT_TILES[-1])
    share = -(-cout // tiles)
    return next(t for t in _COUT_TILES if t >= share), tiles


def conv_plan(dtype: torch.dtype, x_shape, cout: int) -> ConvPlan:
    """The kernel's plan for x of ``x_shape`` (NHWC) in ``dtype`` and
    ``cout`` output channels, from the shape alone (the CPU can ask). The
    bf16 kernel keeps two staging buffers where they fit and one where
    not; ``fits`` says whether the least it needs fits a block."""
    _, h, wd, cin = x_shape
    tile, tiles = cout_tiling(cout)
    if kernel_route(dtype) == "mma":
        def smem(nbuf: int) -> int:
            staged = nbuf * _staged_rows(_MMA_PIXELS, wd) * (wd + 2) * _ROW_STRIDE
            return 2 * (9 * tile * _ROW_STRIDE + staged + _MMA_PIXELS * (tile + 8))

        nbuf = 2 if smem(2) <= _MAX_SMEM else 1
        warps = 4 * (2 if tile > 64 else 1)
        return ConvPlan("mma", tile, tiles, nbuf, smem(nbuf), -(-h * wd // _MMA_PIXELS) * tiles * warps)
    pixels = _THREADS // (tile // _CH_PER_THREAD) * _PIX_PER_THREAD
    smem = 4 * (9 * cin * tile + _staged_rows(pixels, wd) * (wd + 2) * cin)
    return ConvPlan("fma", tile, tiles, 1, smem, -(-h * wd // pixels) * tiles)


def supports(x_shape, cout: Optional[int] = None, dtype: Optional[torch.dtype] = None) -> bool:
    """When the model routes encoder block1 through this kernel: the JAX
    package's predicate without its TPU memory clause (narrow input
    channels, 8-aligned spatial dims) and, given ``cout`` and ``dtype``,
    a plan that fits a block's shared memory (:func:`conv_plan`)."""
    _, h, w, c = x_shape
    if c > _MAX_CIN or h % 8 or w % 8:
        return False
    return cout is None or conv_plan(dtype, x_shape, cout).fits


def kernel_route(dtype: torch.dtype) -> str:
    """Which kernel of ``csrc/boundary_conv.cu`` a CUDA tensor of this dtype
    launches: "mma" (bf16, tensor cores) or "fma" (f32, CUDA cores)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def fold_vectorised(cout: int, itemsize: int) -> bool:
    """Whether the fold kernel takes its 16-byte layout for this Cout (a
    multiple of a vector's elements, at most one vector per thread of its
    256), else its element-by-element one."""
    vec = 16 // itemsize
    return cout % vec == 0 and cout // vec <= _THREADS


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
    if not _build.runs_kernel(x.device):
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
    if cin > _MAX_CIN or cout < 1 or tuple(b.shape) != (cout,):
        raise ValueError(
            f"conv3x3_same_stats: takes Cin <= {_MAX_CIN} and a (Cout,) bias; "
            f"got Cin {cin}, Cout {cout}, bias {tuple(b.shape)}"
        )
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3_same_stats: x, w and b must be on one device")
    if not x.is_contiguous():
        raise ValueError("conv3x3_same_stats: x must be contiguous (NHWC)")
    code = _build.dtype_code(x)
    plan = conv_plan(x.dtype, x.shape, cout)
    if not plan.fits:
        raise ValueError(f"conv3x3_same_stats: {plan} needs more shared memory than a block has "
                         "(supports() says False for this shape)")
    wc = w.to(x.dtype).contiguous()
    bc = b.to(x.dtype).contiguous()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, n, plan.parts), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    err = _build.lib().lg_conv3x3_same_stats(
        code, x.data_ptr(), wc.data_ptr(), bc.data_ptr(), y.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        n, h, wd, cin, cout, plan.cout_tile, _build.stream_ptr(x.device),
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
    if not _build.runs_kernel(y.device):
        return conv3x3_bwd_fold_plain(y, gy, gs1, gs2)
    what = "conv3x3_bwd_fold"
    refuse_grad(what, "BoundaryConvS2D", y, gy, gs1, gs2)
    if y.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {y.device}")
    if y.dim() != 4 or not y.is_contiguous():
        raise ValueError(f"{what}: y must be a contiguous NHWC tensor, got {tuple(y.shape)}")
    if gy.shape != y.shape or gy.dtype != y.dtype or gy.device != y.device or not gy.is_contiguous():
        raise ValueError(f"{what}: gy must be contiguous {y.dtype} {tuple(y.shape)} on {y.device}")
    n, h, wd, cout = y.shape
    vec = fold_vectorised(cout, y.element_size())
    if vec and (y.data_ptr() % 16 or gy.data_ptr() % 16):
        raise ValueError(f"{what}: y and gy must be 16-byte aligned (the kernel moves 16-byte vectors)")
    for name, t in (("gs1", gs1), ("gs2", gs2)):
        if t.shape != (n,) or t.dtype != torch.float32 or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous f32 ({n},) on {y.device}")
    code = _build.dtype_code(y)
    pixels = n * h * wd
    blocks = -(-pixels // _FOLD_BLOCK_PIXELS)
    out = torch.empty_like(y)
    part = torch.empty((blocks, cout), dtype=torch.float32, device=y.device)
    db = torch.empty((cout,), dtype=torch.float32, device=y.device)
    err = _build.lib().lg_conv3x3_bwd_fold(
        code, y.data_ptr(), gy.data_ptr(), gs1.data_ptr(), gs2.data_ptr(), out.data_ptr(), part.data_ptr(),
        db.data_ptr(), pixels, h * wd, cout, _FOLD_BLOCK_PIXELS, blocks, int(vec), _build.stream_ptr(y.device),
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
