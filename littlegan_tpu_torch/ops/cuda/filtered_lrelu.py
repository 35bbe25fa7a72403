"""StyleGAN3's filtered LeakyReLU over channels-last maps (S6): the CUDA
kernels' wrapper (``csrc/filtered_lrelu.cu``), their plain version and the
autograd Function every filtered layer of ``models/stylegan3.py`` ends in.

:func:`filtered_lrelu` ``(y, b, d, fu, fd, up, down, padding, gain, slope,
clamp)`` is ``torch_utils/ops/filtered_lrelu.py``'s op of NVlabs/stylegan3
in the order of its ``_filtered_lrelu_ref``, with the modulated conv's
demodulation taken in the same read::

    pre = y * d[n, c] + b[c]
    u   = upfirdn2d(pre, fu, up, padding, gain=up**2)   # the 1-D filter on each axis
    v   = clamp(lrelu(u, slope) * gain, +-clamp)
    out = upfirdn2d(v, fd, down)

Along one axis, with xz the map with ``up - 1`` zeros after every sample
and zero outside it, ``u[t] = sum_a fu[a] xz[t + a - p0]`` for t in [0, T)
and ``out[o] = sum_e fd[e] v[o * down + e]`` (the filters are symmetric, so
upfirdn2d's flip changes nothing); ``p0`` is the padding ahead, negative
for a crop. The backward is the same two passes in the adjoint form: the
gradient g zero-inserted by ``down`` and filtered by fd (padding ``Kd -
1``), times the saved slope, gain and clamp, then filtered by fu and kept
at every ``up``-th sample from ``p0 - Ku + 1``. ``pre``'s gradient gx gives
y's ``gx * d``, d's ``sum_{h, w} gx y`` and b's ``sum gx``.

The kernels (``csrc/filtered_lrelu.cu``) keep the upsampled intermediate
in shared memory: the forward writes the output and a 2-bit mask (the
sign and whether the clamp cut) of each intermediate sample, 8 channels
to a 16-bit word; the backward reads the gradient, the mask and y. Both
compute in float32 and round once at their outputs. No second order:
StyleGAN3-T has no path-length penalty and D runs no S6, so the
backward's backward raises.

A CPU tensor takes the plain version (the same steps in PyTorch, the mask
as two boolean maps), and so does a CUDA tensor under
``_build.plain_versions()``; a CUDA tensor launches the kernels, any other
device raises. Counters ``stylegan3.filtered_lrelu`` and
``stylegan3.filtered_lrelu_bwd``: one count a forward and a backward call,
on either device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from littlegan_tpu_torch.ops.cuda import _build

CALLS = _build.LaunchCounter("stylegan3.filtered_lrelu")
BWD_CALLS = _build.LaunchCounter("stylegan3.filtered_lrelu_bwd")
CL = torch.channels_last
CHANNELS = 8  # channels of a kernel block, and of a mask word
MAX_TAPS = 24
# (up, up taps, down, down taps) the kernels are built for, and the output
# tile (rows, columns) each pass takes: the adjoint form of an up-4 layer
# reads a 52-sample window for 8 outputs, so it takes 8 x 8
FORMS = {(2, 12, 2, 12): (16, 16), (4, 24, 2, 12): (16, 16), (2, 12, 4, 24): (8, 8)}
GROUP_UP = 4  # intermediate samples a thread filters at once in an up pass


class Axis(NamedTuple):
    """One axis of a pass: ``u[t] = sum_a f1[a] xz[t + a - p0]`` over an
    input of ``L`` samples zero-inserted by ``U``, t in [0, T); ``out[o] =
    sum_e f2[e] v[o * D + e + q0]`` (v zero outside [0, T)), o in [0, O)."""

    L: int
    U: int
    K1: int
    p0: int
    T: int
    D: int
    K2: int
    q0: int
    O: int


def forward_axis(length: int, up: int, down: int, ku: int, kd: int, pad_lo: int, pad_hi: int) -> Axis:
    t = length * up + pad_lo + pad_hi - ku + 1
    return Axis(length, up, ku, pad_lo, t, down, kd, 0, (t - kd) // down + 1)


def adjoint(a: Axis) -> Axis:
    """The backward's axis: the gradient up by D through f2, down by U through f1."""
    return Axis(a.O, a.D, a.K2, a.K2 - 1, a.T, a.U, a.K1, a.p0 - a.K1 + 1, a.L)


class Spec(NamedTuple):
    """A layer's constants: its two filters, both axes of the forward, the
    gain, the slope and the clamp."""

    fu: Tuple[float, ...]
    fd: Tuple[float, ...]
    h: Axis
    w: Axis
    gain: float
    slope: float
    clamp: float

    @property
    def up_gain(self) -> float:
        return float(self.h.U * self.w.U)


def make_spec(height: int, width: int, fu: Sequence[float], fd: Sequence[float], up: int, down: int,
              padding: Sequence[int], gain: float, slope: float, clamp: float) -> Spec:
    """The spec of a (height, width) input; ``padding`` (px0, px1, py0, py1) as upfirdn2d's."""
    fu, fd = tuple(float(v) for v in fu), tuple(float(v) for v in fd)
    for f, name in ((fu, "fu"), (fd, "fd")):
        if f != f[::-1]:
            raise ValueError(f"filtered_lrelu: {name} must be symmetric")
    px0, px1, py0, py1 = padding
    return Spec(fu, fd, forward_axis(height, up, down, len(fu), len(fd), py0, py1),
                forward_axis(width, up, down, len(fu), len(fd), px0, px1), float(gain), float(slope), float(clamp))


# ------------------------------------------------------------ plain version --


def _pad(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """x padded with zeros (cropped where negative) by lo ahead and hi after along ``dim`` (2 or 3)."""
    return F.pad(x, [0, 0, lo, hi] if dim == 2 else [lo, hi])


def _taps(f: torch.Tensor, c: int, dim: int) -> torch.Tensor:
    k = f.numel()
    return f.reshape(1, 1, k, 1).expand(c, 1, k, 1) if dim == 2 else f.reshape(1, 1, 1, k).expand(c, 1, 1, k)


def up_pass(x: torch.Tensor, dim: int, a: Axis, f: torch.Tensor) -> torch.Tensor:
    """``u[t] = sum_a f[a] xz[t + a - p0]`` along ``dim``, t in [0, a.T)."""
    if a.U > 1:
        shape = list(x.shape)
        shape[dim] *= a.U
        xz = x.new_zeros(shape)
        if dim == 2:
            xz[:, :, ::a.U] = x
        else:
            xz[:, :, :, ::a.U] = x
    else:
        xz = x
    xp = _pad(xz, dim, a.p0, a.T + a.K1 - 1 - a.L * a.U - a.p0)
    return F.conv2d(xp, _taps(f.to(x.dtype), x.shape[1], dim), groups=x.shape[1])


def down_pass(v: torch.Tensor, dim: int, a: Axis, f: torch.Tensor) -> torch.Tensor:
    """``out[o] = sum_e f[e] v[o * D + e + q0]`` along ``dim``, o in [0, a.O)."""
    vp = _pad(v, dim, -a.q0, (a.O - 1) * a.D + a.K2 - (a.T - a.q0))
    stride = (a.D, 1) if dim == 2 else (1, a.D)
    return F.conv2d(vp, _taps(f.to(v.dtype), v.shape[1], dim), stride=stride, groups=v.shape[1])


def _acc(y: torch.Tensor) -> torch.dtype:
    return torch.promote_types(y.dtype, torch.float32)


def forward_plain(y, b, d, fu, fd, spec: Spec):
    """(out, (negative, clamped)): the forward kernel's arithmetic in
    PyTorch, the two masks at the intermediate resolution."""
    acc = _acc(y)
    x = y.to(acc)
    if d is not None:
        x = x * d.to(acc)[:, :, None, None]
    x = x + b.to(acc)[None, :, None, None]
    z = up_pass(up_pass(x, 2, spec.h, fu.to(acc)), 3, spec.w, fu.to(acc)) * spec.up_gain
    neg = ~(z > 0)
    v = torch.where(neg, z * (spec.gain * spec.slope), z * spec.gain)
    cut = v.abs() > spec.clamp
    v = v.clamp(-spec.clamp, spec.clamp)
    out = down_pass(down_pass(v, 2, spec.h, fd.to(acc)), 3, spec.w, fd.to(acc)).to(y.dtype)
    return (out.contiguous(memory_format=CL) if y.is_contiguous(memory_format=CL) else out), (neg, cut)


def backward_plain(g, mask, y, d, fu, fd, spec: Spec, want_d: bool):
    """(gy, gd, gb): the backward kernel's arithmetic in PyTorch; gy in y's
    dtype, gd (N, C) and gb (C,) float32 (gd None where not wanted)."""
    neg, cut = mask
    acc = _acc(y)
    h, w = adjoint(spec.h), adjoint(spec.w)
    gv = up_pass(up_pass(g.to(acc), 2, h, fd.to(acc)), 3, w, fd.to(acc))
    k = spec.gain * spec.up_gain
    gz = torch.where(cut, 0.0, torch.where(neg, gv * (k * spec.slope), gv * k))
    gx = down_pass(down_pass(gz, 2, h, fu.to(acc)), 3, w, fu.to(acc))
    gy = gx if d is None else gx * d.to(acc)[:, :, None, None]
    gd = (gx * y.to(acc)).sum((2, 3)) if want_d and d is not None else None
    return gy.to(y.dtype), gd, gx.sum((0, 2, 3))


# ------------------------------------------------------------------ kernels --


def tiles(a: Axis, form, axis: int) -> Tuple[int, int]:
    """(output tile, tiles) of one axis (0 rows, 1 columns) of a pass of ``form`` (a FORMS key)."""
    to = FORMS[form][axis]
    return to, -(-a.O // to)


def smem_floats(ah: Axis, aw: Axis, form) -> Tuple[int, int]:
    """Per channel, the floats of the two shared-memory regions a block of
    this pass needs at the most: the input tile, then the intermediate;
    the first up pass's rows, then the first down pass's (rows walked down
    by a pass have an odd pitch, as ``csrc/filtered_lrelu.cu`` lays them)."""
    def dims(a: Axis, to: int):
        trp = -(-((to - 1) * a.D + a.K2 + a.U - 1) // GROUP_UP) * GROUP_UP
        return trp, (trp + a.K1 - 2) // a.U + 1

    th, tw = FORMS[form]
    (rh, ih), (rw, iw) = dims(ah, th), dims(aw, tw)
    return max(ih * iw, rh * (rw + 1)), max(rh * (iw | 1), th * (rw + 1))


def _f32_array(f: Sequence[float]):
    return (ctypes.c_float * MAX_TAPS)(*f, *([0.0] * (MAX_TAPS - len(f))))


def _launch(mode: int, x, out, d, b, mask, yc, part_b, part_d, ah: Axis, aw: Axis, f1, f2, fgain: float,
            gain: float, slope: float, clamp: float, what: str) -> None:
    form = (ah.U, ah.K1, ah.D, ah.K2)
    if form not in FORMS or (aw.U, aw.K1, aw.D, aw.K2) != form:
        raise ValueError(f"{what}: (up, up taps, down, down taps) must be one of {sorted(FORMS)}, got {form}")
    n, c = x.shape[0], x.shape[1]
    (toh, nth), (tow, ntw) = tiles(ah, form, 0), tiles(aw, form, 1)
    sa, sb = smem_floats(ah, aw, form)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.lib().lg_filtered_lrelu(
        _build.dtype_code(x), mode, *form, ptr(x), ptr(out), ptr(d), ptr(b), ptr(mask), ptr(yc), ptr(part_b),
        ptr(part_d), n, c, ah.L, ah.p0, ah.T, ah.q0, ah.O, toh, nth, aw.L, aw.p0, aw.T, aw.q0, aw.O, tow, ntw,
        _f32_array(f1), _f32_array(f2), fgain, gain, slope, clamp, sa, sb, _build.stream_ptr(x.device))
    _build.check(err, what)


def _checked(t: torch.Tensor, what: str, name: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {name} on {t.device}")
    if t.dim() != 4:
        raise ValueError(f"{what}: expected {name} (B, C, H, W), got shape {tuple(t.shape)}")
    return t.contiguous(memory_format=CL)


def _small(t: Optional[torch.Tensor], shape, y: torch.Tensor, what: str, name: str):
    if t is None:
        return None
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != y.device:
        raise ValueError(f"{what}: {name} must be float32 {tuple(shape)} on {y.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def unpack_mask(mask: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (N, T_h, T_w, words) mask as the plain version's
    (negative, clamped) boolean (N, C, T_h, T_w) maps."""
    words = mask.to(torch.int32) & 0xFFFF
    bits = torch.arange(2 * CHANNELS, device=mask.device, dtype=torch.int32)
    flat = ((words[..., None] >> bits) & 1).bool()  # (N, T_h, T_w, words, 16)
    neg = flat[..., :CHANNELS].flatten(3)[..., :c].permute(0, 3, 1, 2)
    cut = flat[..., CHANNELS:].flatten(3)[..., :c].permute(0, 3, 1, 2)
    return neg, cut


def mask_words(n: int, c: int, a_h: Axis, a_w: Axis) -> Tuple[int, int, int, int]:
    """The mask's shape: a 16-bit word per (sample, intermediate row, column, 8 channels)."""
    return n, a_h.T, a_w.T, -(-c // CHANNELS)


def forward_kernel(y, b, d, spec: Spec):
    """(out, mask) from the forward kernel: y a (B, C, H, W) CUDA map,
    float32 or bfloat16; out in y's dtype, channels-last; mask int16."""
    what = "filtered_lrelu"
    y = _checked(y, what, "y")
    n, c, hh, ww = y.shape
    if (hh, ww) != (spec.h.L, spec.w.L):
        raise ValueError(f"{what}: the spec is for a {spec.h.L}x{spec.w.L} map, got {hh}x{ww}")
    b = _small(b, (c,), y, what, "b")
    d = _small(d, (n, c), y, what, "d")
    out = torch.empty((n, c, spec.h.O, spec.w.O), dtype=y.dtype, device=y.device, memory_format=CL)
    mask = torch.empty(mask_words(n, c, spec.h, spec.w), dtype=torch.int16, device=y.device)
    _launch(0, y, out, d, b, mask, None, None, None, spec.h, spec.w, spec.fu, spec.fd, spec.up_gain, spec.gain,
            spec.slope, spec.clamp, what)
    return out, mask


def backward_kernel(g, mask, y, d, spec: Spec, like: Tuple[torch.Size, torch.dtype]):
    """(gy, gd, gb) from the backward kernel: ``like`` y's (shape, dtype);
    gy in that dtype, channels-last; gd (N, C) and gb (C,) float32 summed
    in a fixed order from each block's column sums. y is read for gd
    alone: None gives no gd."""
    what = "filtered_lrelu_bwd"
    shape, dtype = like
    g = _checked(g, what, "g").to(dtype)
    y = None if y is None or d is None else _checked(y, what, "y")
    n, c = shape[:2]
    d = _small(d, (n, c), g, what, "d")
    ah, aw = adjoint(spec.h), adjoint(spec.w)
    form = (ah.U, ah.K1, ah.D, ah.K2)
    nt = tiles(ah, form, 0)[1] * tiles(aw, form, 1)[1]
    gy = torch.empty(shape, dtype=dtype, device=g.device, memory_format=CL)
    f32 = dict(dtype=torch.float32, device=g.device)
    part_b = torch.empty((n, nt, c), **f32)
    part_d = torch.empty((n, nt, c), **f32) if y is not None else None
    _launch(1, g, gy, d, None, mask, y, part_b, part_d, ah, aw, spec.fd, spec.fu, 1.0, spec.gain * spec.up_gain,
            spec.slope, spec.clamp, what)
    return gy, None if part_d is None else part_d.sum(1), part_b.sum((0, 1))


# ----------------------------------------------------------------- autograd --


class FilteredLReLU(torch.autograd.Function):
    """The op; its backward reads the saved mask (first order only)."""

    @staticmethod
    def forward(ctx, y, b, d, fu, fd, spec: Spec):
        CALLS.add()
        ctx.spec = spec
        if _build.runs_kernel(y.device):
            out, mask = forward_kernel(y, b, d, spec)
            ctx.kernel, masks = True, (mask,)
        else:
            out, masks = forward_plain(y, b, d, fu, fd, spec)
            ctx.kernel = False
        ctx.n_masks = len(masks)
        keep_y = d is not None and ctx.needs_input_grad[2]
        ctx.save_for_backward(y if keep_y else None, d, fu, fd, *masks)
        ctx.y_meta = (y.shape, y.dtype)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        BWD_CALLS.add()
        y, d, fu, fd, *masks = ctx.saved_tensors
        spec, want_d = ctx.spec, ctx.needs_input_grad[2]
        if ctx.kernel:
            gy, gd, gb = backward_kernel(g, masks[0], y if want_d else None, d, spec, ctx.y_meta)
        else:
            like = torch.empty(ctx.y_meta[0], dtype=ctx.y_meta[1], device=g.device) if y is None else y
            gy, gd, gb = backward_plain(g, tuple(masks), like, d, fu, fd, spec, want_d)
        return (gy if ctx.needs_input_grad[0] else None, gb if ctx.needs_input_grad[1] else None, gd, None, None,
                None)


def filtered_lrelu(y: torch.Tensor, b: torch.Tensor, d: Optional[torch.Tensor], fu: torch.Tensor,
                   fd: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The op of a (B, C, H, W) map y (module docstring): b (C,) and d (B,
    C) float32 (d may be None), fu and fd the filters as tensors on y's
    device (the plain version's), ``spec`` from :func:`make_spec`. On a
    CUDA tensor the result lies channels-last."""
    return FilteredLReLU.apply(y, b, d, fu, fd, spec)
