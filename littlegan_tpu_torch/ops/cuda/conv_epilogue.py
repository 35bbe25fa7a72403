"""StarGAN v2's convolution epilogue over channels-last maps: the CUDA
kernels' wrappers (``csrc/conv_epilogue.cu``), their plain versions and the
autograd Functions every biased convolution of ``models/stargan_v2.py``
ends in.

:func:`conv_epilogue` ``(y, b, sc, s)`` is ``s * (y + b[c] + sc)``: y a
convolution's output without its bias, b the float32 bias parameter
itself, sc a residual block's shortcut (``s`` = 1/sqrt(2) after the
block's second conv) or none (``s`` = 1). The sum is taken in float32 and
rounded to y's dtype once. Its backward, from the gradient g, is ``s * g``
for y and for sc (one tensor; g itself where ``s`` is 1) and ``s * sum g``
over (N, H, W) for b, a float32 column sum in the same read of g. The
backward (:class:`EpilogueBwd`) is a Function whose own backward is the
forward without sc, its adjoint, so gradients of any order run on the two
kernels, and R1's double backward through the discriminator's convs sends
nothing back into the forward's graph.

Replaces no TPU kernel: the JAX package has no StarGAN v2. What bounds the
kernels is bytes; ``csrc/conv_epilogue.cu`` says how they read and write
16-byte vectors of channels and how the column sum is split over blocks
(:func:`plan`) and added in one fixed order. A CPU tensor takes the plain
versions, and so does a CUDA tensor under ``_build.plain_versions()``; a
CUDA tensor launches the kernels, any other device raises. Counters
``stargan_v2.conv_epilogue`` and ``stargan_v2.conv_epilogue_bwd``: one count
per call of the forward and of the backward (a double backward's calls of
the forward included), on either device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda.norm_lrelu import _sms

CALLS = _build.LaunchCounter("stargan_v2.conv_epilogue")
BWD_CALLS = _build.LaunchCounter("stargan_v2.conv_epilogue_bwd")

_TILE = 64  # channels of a backward block
_THREADS = 256
_MIN_ITERS = 4  # rows a thread adds at the least in a split
_BLOCKS_PER_SM = 4  # a backward launch's blocks


def plan(rows: int, c: int, vec: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk): the blocks of a channel tile in the backward's
    column sum over ``rows`` rows of ``c`` channels, ``vec`` channels a
    thread, and the rows each takes. Enough blocks for ``_BLOCKS_PER_SM``
    an SM over the launch, each thread adding at least ``_MIN_ITERS`` rows.
    One split is one launch."""
    width = min(_TILE, c)
    per_pass = _THREADS // -(-width // vec)
    tiles = -(-c // _TILE)
    splits = max(1, min(-(-rows // (per_pass * _MIN_ITERS)), -(-sms * _BLOCKS_PER_SM // tiles)))
    chunk = -(-rows // splits)
    return -(-rows // chunk), chunk


def conv_epilogue_plain(y: torch.Tensor, b: Optional[torch.Tensor], sc: Optional[torch.Tensor],
                        s: float) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch: ``(y + b) + sc``, then
    times s, in float32 (or y's wider dtype), one rounding at the output."""
    acc = torch.promote_types(y.dtype, torch.float32)
    out = y.to(acc)
    if b is not None:
        out = out + b.to(acc)[:, None, None]
    if sc is not None:
        out = out + sc.to(acc)
    return (out * s).to(y.dtype)


def conv_epilogue_bwd_plain(g: torch.Tensor, s: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gs, db): the backward kernels' arithmetic in PyTorch. gs is ``s *
    g`` in g's dtype (g itself where s is 1), db ``s`` times the sum of g
    over (N, H, W) in float32 (or g's wider dtype)."""
    acc = torch.promote_types(g.dtype, torch.float32)
    db = g.to(acc).sum((0, 2, 3)) * s
    return (g if s == 1.0 else (g.to(acc) * s).to(g.dtype)), db


def _check(t: torch.Tensor, what: str, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {name} on {t.device}")
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: expected {name} (B, C, H, W) in channels-last memory, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")


def _vec(t: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """Whether a thread takes a 16-byte vector of channels: C a multiple of
    the vector and every tensor 16-byte aligned."""
    v = 16 // t.element_size()
    return t.shape[1] % v == 0 and all(o.data_ptr() % 16 == 0 for o in (t, *others) if o is not None)


def conv_epilogue_fwd(y: torch.Tensor, b: Optional[torch.Tensor], sc: Optional[torch.Tensor],
                      s: float) -> torch.Tensor:
    """``s * ((y + b) + sc)`` from the kernel: y (and sc, of y's shape and
    dtype) float32 or bfloat16 in channels-last memory, b float32 (C,) or
    None; the result in y's dtype and layout."""
    what = "conv_epilogue"
    _check(y, what, "y")
    c = y.shape[1]
    if sc is not None:
        _check(sc, what, "sc")
        if sc.shape != y.shape or sc.dtype != y.dtype or sc.device != y.device:
            raise ValueError(f"{what}: sc {sc.dtype} {tuple(sc.shape)} on {sc.device} is not y's "
                             f"{y.dtype} {tuple(y.shape)} on {y.device}")
    if b is not None:
        if b.dtype != torch.float32 or b.shape != (c,) or b.device != y.device:
            raise ValueError(f"{what}: b must be float32 ({c},) on {y.device}, got {b.dtype} {tuple(b.shape)} "
                             f"on {b.device}")
        b = b.contiguous()
    out = torch.empty_like(y, memory_format=torch.channels_last)
    err = _build.lib().lg_conv_epilogue(
        _build.dtype_code(y), int(_vec(y, sc, out)), y.data_ptr(), None if b is None else b.data_ptr(),
        None if sc is None else sc.data_ptr(), out.data_ptr(), y.numel(), c, s, _build.stream_ptr(y.device))
    _build.check(err, what)
    return out


def conv_epilogue_bwd(g: torch.Tensor, s: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gs, db) from the kernels: gs ``s * g`` in g's dtype and channels-last
    memory (g itself where s is 1), db float32 (C,) ``s`` times the column
    sum. g is brought to channels-last memory where it arrives otherwise."""
    what = "conv_epilogue_bwd"
    if g.dim() == 4 and g.device.type == "cuda":
        g = g.contiguous(memory_format=torch.channels_last)
    _check(g, what, "g")
    n, c, h, w = g.shape
    rows = n * h * w
    gs = g if s == 1.0 else torch.empty_like(g, memory_format=torch.channels_last)
    vec = _vec(g, gs)
    splits, chunk = plan(rows, c, 16 // g.element_size() if vec else 1, _sms(g.device))
    db = torch.empty(c, dtype=torch.float32, device=g.device)
    part = torch.empty((splits, c), dtype=torch.float32, device=g.device) if splits > 1 else db
    err = _build.lib().lg_conv_epilogue_bwd(
        _build.dtype_code(g), int(vec), g.data_ptr(), None if gs is g else gs.data_ptr(), part.data_ptr(),
        db.data_ptr(), rows, c, splits, chunk, s, _build.stream_ptr(g.device))
    _build.check(err, what)
    return gs, db


class Epilogue(torch.autograd.Function):
    """``s * ((y + b) + sc)`` (b and sc may be None); its backward
    :class:`EpilogueBwd`, itself differentiable."""

    @staticmethod
    def forward(ctx, y, b, sc, s: float):
        CALLS.add()
        ctx.s = s
        fwd = conv_epilogue_fwd if _build.runs_kernel(y.device) else conv_epilogue_plain
        return fwd(y, b, sc, s)

    @staticmethod
    def backward(ctx, g):
        need_y, need_b, need_sc = ctx.needs_input_grad[:3]
        if need_b:
            gy, db = EpilogueBwd.apply(g, ctx.s)
        else:
            gy, db = scale(g, ctx.s), None
        return gy if need_y else None, db, gy if need_sc else None, None


class EpilogueBwd(torch.autograd.Function):
    """(``s * g``, ``s * sum g`` over (N, H, W)); its backward, the adjoint
    ``s * (gg + gdb[c])``, is :class:`Epilogue` without sc."""

    @staticmethod
    def forward(ctx, g, s: float):
        BWD_CALLS.add()
        ctx.s = s
        ctx.set_materialize_grads(False)
        ctx.meta = g.shape, g.dtype, g.device
        bwd = conv_epilogue_bwd if _build.runs_kernel(g.device) else conv_epilogue_bwd_plain
        return bwd(g, s)

    @staticmethod
    def backward(ctx, gg, gdb):
        if gdb is None:
            return (None if gg is None else scale(gg, ctx.s)), None
        if gg is None:
            shape, dtype, device = ctx.meta
            gg = torch.zeros(shape, dtype=dtype, device=device).contiguous(memory_format=torch.channels_last)
        return Epilogue.apply(gg, gdb, None, ctx.s), None


def scale(g: torch.Tensor, s: float) -> torch.Tensor:
    """``s * g``: g itself where s is 1, else the epilogue without b and sc."""
    return g if s == 1.0 else Epilogue.apply(g, None, None, s)


def conv_epilogue(y: torch.Tensor, b: Optional[torch.Tensor], sc: Optional[torch.Tensor] = None,
                  s: float = 1.0) -> torch.Tensor:
    """``s * (y + b[c] + sc)`` of a (B, C, H, W) convolution output y, b
    the float32 (C,) bias (or None), sc the shortcut (or None). On a CUDA
    tensor y and sc must lie in channels-last memory; the result does."""
    return Epilogue.apply(y, b, sc, s)
