"""StyleGAN2's layer epilogue over channels-last maps (S5): the CUDA
kernels' wrappers (``csrc/bias_act.cu``), their plain versions and the
autograd Functions every biased layer of ``models/stylegan2.py`` ends in.

:func:`bias_act` ``(y, b, d, noise, noise_strength, act, gain)`` is the
modulated layer's tail and NVlabs' ``bias_act`` in one pass::

    pre = ((y * d[n, c]) + noise * noise_strength) + b[c]
    out = clamp(lrelu(pre, 0.2) * sqrt(2) * gain, +-CLAMP * gain)

(``pre * gain`` without ``act``; ``pre = y + b`` without the modulation.)
y is a convolution's output in its compute dtype, b the float32 bias; a
modulated layer adds d, the float32 (N, C) demodulation, with noise, the
(N, 1, H, W) noise map (read in y's dtype), and ``noise_strength``, all
three or none. b and the noise strength are the parameters themselves: the
kernels read them from device memory, so a CUDA graph that steps them stays
valid. The
arithmetic is float32 (or y's wider dtype), each op rounded on its own, the
output once to y's dtype; the LeakyReLU and the gain are one multiply by
the slope ``sqrt(2) gain`` or ``0.2 sqrt(2) gain``.

The backward (:class:`BiasActBwd`) reads the gradient g and the saved y
alone and works the pre-activation out again. The sign and the clamp's
range are constants, as in the published ``bias_act.cu`` (bounds included,
as ``torch.clamp``'s): ``gpre = [|v| <= CLAMP gain] g slope``, y's gradient
``gpre d``, d's ``sum_{h, w} gpre y``, b's ``sum gpre``, the noise
strength's ``sum gpre noise``, each reduction where its input needs a
gradient; the noise map takes none. Its own backward, for the path-length
penalty's and R1's double backwards, is the second-order kernel, so the
penalties' graphs never differentiate the forward's ops.

Replaces no TPU kernel: the JAX package has no StyleGAN2. What bounds the
kernels is bytes; ``csrc/bias_act.cu`` says how they read and write 16-byte
vectors of channels and how the reductions are split over blocks
(:func:`plan`) and added in one fixed order. A CPU tensor takes the plain
versions, and so does a CUDA tensor under ``_build.plain_versions()``; a
CUDA tensor launches the kernels, any other device raises. Counters
``stylegan2.bias_act``, ``stylegan2.bias_act_bwd`` and
``stylegan2.bias_act_bwd2``: one count each time the forward's, the
backward's and the second order's wrapper launches its kernel (the second
order launches nothing where no gradient reaches g, y or d).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda.norm_lrelu import _sms

LAUNCHES = _build.LaunchCounter("stylegan2.bias_act")
BWD_LAUNCHES = _build.LaunchCounter("stylegan2.bias_act_bwd")
BWD2_LAUNCHES = _build.LaunchCounter("stylegan2.bias_act_bwd2")
ALPHA = 0.2
CLAMP = 256.0  # NVlabs' conv_clamp: every StyleGAN2 layer that ends in bias_act clamps at +-CLAMP * gain
CL = torch.channels_last

_TILE = 64  # channels of a block
_THREADS = 256
_MIN_ITERS = 4  # pixels a thread takes at the least in a split
_BLOCKS_PER_SM = 4  # a backward launch's blocks
_FWD_BLOCKS_PER_SM = 8  # a forward launch's: fewer registers, more blocks resident


class Slopes(NamedTuple):
    """The epilogue's constants: the slope times the gain where the
    pre-activation is above 0 and elsewhere, and the clamp's bound."""

    gain: float
    again: float
    bound: float


def slopes(act: bool, gain: float) -> Slopes:
    g = math.sqrt(2.0) * gain if act else gain
    return Slopes(g, ALPHA * g if act else g, CLAMP * gain)


def plan(n: int, c: int, hw: int, vec: int, sms: int, per_sm: int = _BLOCKS_PER_SM) -> Tuple[int, int]:
    """(splits, chunk): the blocks of a sample's channel tile in a launch,
    and the pixels each takes, for n samples of hw pixels and c channels,
    ``vec`` channels a thread. Enough blocks for ``per_sm`` an SM over the
    launch, each thread taking at least ``_MIN_ITERS`` pixels."""
    lanes = -(-min(_TILE, c) // vec)
    rows = _THREADS // lanes
    tiles = -(-c // _TILE)
    splits = max(1, min(-(-hw // (rows * _MIN_ITERS)), -(-sms * per_sm // (n * tiles))))
    chunk = -(-hw // splits)
    return -(-hw // chunk), chunk


# ------------------------------------------------------------ plain versions --


def _acc(y: torch.Tensor) -> torch.dtype:
    return torch.promote_types(y.dtype, torch.float32)


def _pre(y, d, noise, ns, b, acc):
    x = y.to(acc)
    if d is not None:
        x = x * d.to(acc)[:, :, None, None] + noise.to(y.dtype).to(acc) * ns.to(acc)
    return x + b.to(acc)[:, None, None]


def _slope_kept(y, d, noise, ns, b, k: Slopes):
    """(slope, k): the slope of each element, and k, the slope where the
    clamp passes the gradient and 0 elsewhere, in float32 (or y's wider
    dtype)."""
    pre = _pre(y, d, noise, ns, b, _acc(y))
    s = torch.where(pre > 0, torch.full_like(pre, k.gain), k.again)
    v = pre * s
    return s, torch.where((v >= -k.bound) & (v <= k.bound), s, 0.0)


def bias_act_plain(y, d, noise, ns, b, k: Slopes) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch; the result in y's dtype
    and, where y lies channels-last, layout."""
    pre = _pre(y, d, noise, ns, b, _acc(y))
    v = pre * torch.where(pre > 0, torch.full_like(pre, k.gain), k.again)
    return v.clamp(-k.bound, k.bound).to(y.dtype)


def bias_act_bwd_plain(g, y, d, noise, ns, b, k: Slopes, want_d: bool, want_b: bool, want_ns: bool):
    """(gy, gd, gb, gns): the backward kernels' arithmetic in PyTorch; gy in
    y's dtype, the sums float32 (or y's wider dtype), None where not wanted."""
    acc = _acc(y)
    gp = g.to(acc) * _slope_kept(y, d, noise, ns, b, k)[1]
    gy = (gp if d is None else gp * d.to(acc)[:, :, None, None]).to(y.dtype)
    gd = (gp * y.to(acc)).sum((2, 3)) if want_d and d is not None else None
    gb = gp.sum((0, 2, 3)) if want_b else None
    gns = (gp * noise.to(y.dtype).to(acc)).sum() if want_ns and noise is not None else None
    return gy, gd, gb, gns


def bias_act_bwd2_plain(g, y, d, noise, ns, b, k: Slopes, ggy, ggd, ggb, ggns, want_g: bool, want_y: bool,
                        want_d: bool):
    """(gg, gyy, gdd): the backward's backward in PyTorch, the gradients of
    g, y and d from those of the backward's outputs (any may be None);
    None where not wanted or no term reaches it."""
    acc = _acc(y)
    kk = _slope_kept(y, d, noise, ns, b, k)[1]
    gg = None
    if want_g:
        terms = []
        if ggy is not None:
            terms.append(ggy.to(acc) if d is None else ggy.to(acc) * d.to(acc)[:, :, None, None])
        if ggd is not None:
            terms.append(ggd.to(acc)[:, :, None, None] * y.to(acc))
        if ggb is not None:
            terms.append(ggb.to(acc)[:, None, None])
        if ggns is not None:
            terms.append(ggns.to(acc) * noise.to(y.dtype).to(acc))
        if terms:
            t = terms[0]
            for u in terms[1:]:
                t = t + u
            gg = (t * kk).to(g.dtype)
    gp = g.to(acc) * kk
    gyy = (ggd.to(acc)[:, :, None, None] * gp).to(y.dtype) if want_y and ggd is not None else None
    gdd = (ggy.to(acc) * gp).sum((2, 3)) if want_d and ggy is not None and d is not None else None
    return gg, gyy, gdd


# ------------------------------------------------------------------ kernels --


def _map(t: torch.Tensor, what: str, name: str) -> torch.Tensor:
    """t in channels-last memory (copied there where it lies otherwise: a
    gradient may arrive in NCHW), checked for the kernels."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {name} on {t.device}")
    if t.dim() != 4:
        raise ValueError(f"{what}: expected {name} (B, C, H, W), got shape {tuple(t.shape)}")
    return t.contiguous(memory_format=CL)


def _small(t: torch.Tensor, shape, y: torch.Tensor, what: str, name: str) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != y.device:
        raise ValueError(f"{what}: {name} must be float32 {tuple(shape)} on {y.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _operands(y, d, noise, ns, b, what: str):
    """(d, noise, ns, b) checked for y's kernels: float32 b, d and noise
    strength, the noise map in y's dtype with unit pixel strides; d, noise
    and ns all given or all None. The caller holds them until the launch."""
    n, c, h, w = y.shape
    if n > 65535 or h * w * c >= 2 ** 31:
        raise ValueError(f"{what}: at most 65535 samples of fewer than 2**31 elements, got {tuple(y.shape)}")
    b = _small(b, (c,), y, what, "b")
    if d is None:
        return None, None, None, b
    d = _small(d, (n, c), y, what, "d")
    if tuple(noise.shape) != (n, 1, h, w) or noise.device != y.device:
        raise ValueError(f"{what}: noise must be ({n}, 1, {h}, {w}) on {y.device}, got {tuple(noise.shape)} on "
                         f"{noise.device}")
    noise = noise.to(y.dtype)
    if noise.stride(3) != 1 or noise.stride(2) != w:
        noise = noise.contiguous()
    return d, noise, _small(ns, (), y, what, "noise_strength"), b


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _epi(d, noise, ns, b):
    """The C interface's (d, noise, the noise's sample stride, ns, b)."""
    return _ptr(d), _ptr(noise), 0 if noise is None else noise.stride(0), _ptr(ns), _ptr(b)


def _vec(*maps: Optional[torch.Tensor]) -> bool:
    """Whether a thread takes a 16-byte vector of channels: C a multiple of
    the vector and every map 16-byte aligned."""
    t = maps[0]
    return t.shape[1] % (16 // t.element_size()) == 0 and all(m.data_ptr() % 16 == 0 for m in maps if m is not None)


def bias_act_kernel(y, d, noise, ns, b, k: Slopes) -> torch.Tensor:
    """The forward from the kernel: y a (B, C, H, W) CUDA map, float32 or
    bfloat16; the result in y's dtype, channels-last."""
    what = "bias_act"
    y = _map(y, what, "y")
    n, c, h, w = y.shape
    d, noise, ns, b = _operands(y, d, noise, ns, b, what)
    out = torch.empty_like(y, memory_format=CL)
    vec = _vec(y, out)
    splits, chunk = plan(n, c, h * w, 16 // y.element_size() if vec else 1, _sms(y.device), _FWD_BLOCKS_PER_SM)
    err = _build.lib().lg_bias_act(_build.dtype_code(y), int(vec), y.data_ptr(), out.data_ptr(), *_epi(d, noise, ns, b),
                                   *k, n, h * w, c, splits, chunk, _build.stream_ptr(y.device))
    _build.check(err, what)
    LAUNCHES.add()
    return out


def bias_act_bwd_kernel(g, y, d, noise, ns, b, k: Slopes, want_d: bool, want_b: bool, want_ns: bool):
    """(gy, gd, gb, gns) from the kernels: gy in y's dtype, channels-last;
    gd (N, C), gb (C,) and gns () float32, None where not wanted."""
    what = "bias_act_bwd"
    y = _map(y, what, "y")
    g = _map(g, what, "g").to(y.dtype)
    n, c, h, w = y.shape
    d, noise, ns, b = _operands(y, d, noise, ns, b, what)
    want_d, want_ns = want_d and d is not None, want_ns and noise is not None
    gy = torch.empty_like(y, memory_format=CL)
    vec = _vec(y, g, gy)
    splits, chunk = plan(n, c, h * w, 16 // y.element_size() if vec else 1, _sms(y.device))
    tiles = -(-c // _TILE)
    f32 = dict(dtype=torch.float32, device=y.device)
    part_d, gd = (torch.empty((n, splits, c), **f32), torch.empty((n, c), **f32)) if want_d else (None, None)
    part_b, gb = (torch.empty((n, splits, c), **f32), torch.empty((c,), **f32)) if want_b else (None, None)
    part_n, gns = (torch.empty((n, splits, tiles), **f32), torch.empty((), **f32)) if want_ns else (None, None)
    err = _build.lib().lg_bias_act_bwd(
        _build.dtype_code(y), int(vec), g.data_ptr(), y.data_ptr(), gy.data_ptr(), *_epi(d, noise, ns, b),
        *k, _ptr(part_d), _ptr(gd), _ptr(part_b), _ptr(gb), _ptr(part_n), _ptr(gns), n, h * w, c, splits,
        chunk, _build.stream_ptr(y.device))
    _build.check(err, what)
    BWD_LAUNCHES.add()
    return gy, gd, gb, gns


def bias_act_bwd2_kernel(g, y, d, noise, ns, b, k: Slopes, ggy, ggd, ggb, ggns, want_g: bool, want_y: bool,
                         want_d: bool):
    """(gg, gyy, gdd) from the kernels: gg in g's dtype and gyy in y's,
    channels-last; gdd (N, C) float32; None where not wanted or no term
    reaches it."""
    what = "bias_act_bwd2"
    y = _map(y, what, "y")
    g = _map(g, what, "g").to(y.dtype)
    n, c, h, w = y.shape
    d, noise, ns, b = _operands(y, d, noise, ns, b, what)
    ggy = None if ggy is None else _map(ggy, what, "ggy").to(y.dtype)
    ggd = None if ggd is None or d is None else _small(ggd, (n, c), y, what, "ggd")
    ggb = None if ggb is None else _small(ggb, (c,), y, what, "ggb")
    ggns = None if ggns is None or d is None else _small(ggns, (), y, what, "ggns")
    want_g = want_g and any(t is not None for t in (ggy, ggd, ggb, ggns))
    want_y, want_d = want_y and ggd is not None, want_d and ggy is not None and d is not None
    if not (want_g or want_y or want_d):
        return None, None, None
    gg = torch.empty_like(y, memory_format=CL) if want_g else None
    gyy = torch.empty_like(y, memory_format=CL) if want_y else None
    vec = _vec(y, g, ggy, gg, gyy)
    splits, chunk = plan(n, c, h * w, 16 // y.element_size() if vec else 1, _sms(y.device))
    f32 = dict(dtype=torch.float32, device=y.device)
    part_d, gdd = (torch.empty((n, splits, c), **f32), torch.empty((n, c), **f32)) if want_d else (None, None)
    err = _build.lib().lg_bias_act_bwd2(
        _build.dtype_code(y), int(vec), g.data_ptr(), y.data_ptr(), _ptr(ggy), _ptr(gg), _ptr(gyy),
        *_epi(d, noise, ns, b), *k, _ptr(ggd), _ptr(ggb), _ptr(ggns), _ptr(part_d), _ptr(gdd), n, h * w, c,
        splits, chunk, _build.stream_ptr(y.device))
    _build.check(err, what)
    BWD2_LAUNCHES.add()
    return gg, gyy, gdd


# ----------------------------------------------------------------- autograd --


class BiasAct(torch.autograd.Function):
    """The epilogue; its backward :class:`BiasActBwd`, itself differentiable."""

    @staticmethod
    def forward(ctx, y, d, noise, ns, b, k: Slopes):
        ctx.k = k
        ctx.save_for_backward(y, d, noise, ns, b)
        fwd = bias_act_kernel if _build.runs_kernel(y.device) else bias_act_plain
        return fwd(y, d, noise, ns, b, k)

    @staticmethod
    def backward(ctx, g):
        y, d, noise, ns, b = ctx.saved_tensors
        need_d, _, need_ns, need_b = ctx.needs_input_grad[1:5]
        gy, gd, gb, gns = BiasActBwd.apply(g, y, d, noise, ns, b, ctx.k, need_d, need_b, need_ns)
        return gy if ctx.needs_input_grad[0] else None, gd, None, gns, gb, None


class BiasActBwd(torch.autograd.Function):
    """(gy, gd, gb, gns) from the gradient g and the saved y; its backward,
    towards g, y and d, is the second-order kernel."""

    @staticmethod
    def forward(ctx, g, y, d, noise, ns, b, k: Slopes, want_d: bool, want_b: bool, want_ns: bool):
        ctx.k = k
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(g, y, d, noise, ns, b)
        bwd = bias_act_bwd_kernel if _build.runs_kernel(y.device) else bias_act_bwd_plain
        return bwd(g, y, d, noise, ns, b, k, want_d, want_b, want_ns)

    @staticmethod
    def backward(ctx, ggy, ggd, ggb, ggns):
        g, y, d, noise, ns, b = ctx.saved_tensors
        need_g, need_y, need_d = ctx.needs_input_grad[:3]
        bwd2 = bias_act_bwd2_kernel if _build.runs_kernel(y.device) else bias_act_bwd2_plain
        gg, gyy, gdd = bwd2(g, y, d, noise, ns, b, ctx.k, ggy, ggd, ggb, ggns, need_g, need_y, need_d)
        return gg, gyy, gdd, None, None, None, None, None, None, None


def bias_act(y: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, noise_strength: Optional[torch.Tensor] = None, act: bool = True,
             gain: float = 1.0) -> torch.Tensor:
    """``clamp(act(y * d[n, c] + noise * noise_strength + b[c]) * gain', +-CLAMP * gain)``
    of a (B, C, H, W) map y (module docstring): b (C,), d (B, C) and
    ``noise_strength`` () float32, noise (B, 1, H, W); d, noise and
    ``noise_strength`` all given or all None. On a CUDA tensor the result
    lies channels-last."""
    if not (d is None) == (noise is None) == (noise_strength is None):
        raise ValueError("bias_act: d, noise and noise_strength are given together or not at all")
    return BiasAct.apply(y, d, noise, noise_strength, b, slopes(act, gain))
