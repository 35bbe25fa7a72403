"""Plain StyleGAN2 in float32 PyTorch: the yardstick of the
``stylegan2-ffhq-256`` cell, and what the port's CPU tests compare with.

Written from the published code (github.com/NVlabs/stylegan2-ada-pytorch,
arXiv:1912.04958 and arXiv:2006.06676): ``training/networks.py`` with the
``skip`` generator and ``resnet`` discriminator, ``training/loss.py``'s
``StyleGAN2Loss`` and ``training/training_loop.py``'s lazy phases, as
``train.py``'s ``paper256`` spec sets them.

- Mapping: z over the root of its mean square (+1e-8), then
  ``mapping_layers`` FCs, weight times ``lr_mul / sqrt(in)``, bias times
  ``lr_mul``, ``lrelu(0.2) * sqrt(2)``; w broadcast to the ``num_ws``
  layers; ``w_avg <- lerp(mean w, w_avg, 0.995)`` on every main z.
- Synthesis: a 4x4 constant; per resolution a modulated 3x3 ``conv0`` with
  ``up`` 2 (a transposed stride-2 conv, then the [1, 3, 3, 1] FIR filter
  padded by 1 with gain 4), a modulated 3x3 ``conv1``, a ToRGB (modulated
  1x1, styles times ``1/sqrt(in)``, no demodulation), the image
  ``upsample2d(img) + torgb``. A modulated conv: ``x * s``, the conv,
  ``* rsqrt(sum (W s)^2 + 1e-8)`` formed per (sample, out, in, tap) as
  published, ``+ noise * strength``, ``+ bias``, ``lrelu * sqrt(2)``,
  clamped at 256.
- Discriminator: fromrgb (1x1), per resolution conv0 (3x3), conv1 (the FIR
  filter padded by 2, a 3x3 stride-2 conv, gain ``sqrt(0.5)``, clamp
  ``256 sqrt(0.5)``), skip (the FIR filter with stride 2, then a 1x1, no
  bias, times ``sqrt(0.5)``); the epilogue: minibatch stddev (groups of
  ``mbstd_group`` samples ``n % (N / G)`` alike, one channel), 3x3 conv,
  FC, FC to one logit. Every conv and FC weight times ``1/sqrt(fan_in)``.
- One iteration ``it``: Gmain ``softplus(-D(G(z)))``; on ``it % 4 == 0``
  Greg at half the batch (path length with ``pl_mean``'s lerp and its
  gradient, times ``pl_weight * 4``); Dmain ``softplus(D(G(z))) +
  softplus(-D(x))``; on ``it % 16 == 0`` Dreg ``sum (dD/dx)^2 * gamma / 2 *
  16``; each followed by its network's ``torch.optim.Adam`` step (lr and
  betas with the lazy ratio ``interval / (interval + 1)``, eps 1e-8);
  then the EMA of G with ``0.5 ** (B / (ema_kimg * 1000))``. Style mixing
  on every G pass: a second z's w from the cutoff on.

The LeakyReLU is written ``where(x.detach() > 0, x, 0.2 x)`` and the clamp
is ``clamp``: their backwards read the forward's sign and range as
constants, as the published CUDA ``bias_act`` does, so a penalty's
gradient reaches the same leaves as there (no ToRGB bias in Greg, no bias
of D's epilogue in Dreg). Those leaves get a zero gradient, as the
published losses' ``gen_img[:, 0, 0, 0] * 0`` and ``real_logits * 0``
give them, and ``torch.optim.Adam`` steps them with it: one step count a
network. The convolutions' input gradients are
the transposed convs of the pair, as ``conv2d_gradfix`` arranges, so the
penalties' double backwards run on first-order convs, and the penalties'
first backwards form no weight gradient (``no_weight_gradients``, as
published). ``upfirdn2d`` is written apart from the
program's: the map zero-inserted, padded, and filtered by a depthwise conv
of the 4x4 outer product of ``[1, 3, 3, 1] / 8``; its backward is autograd's
adjoint (the conv's transpose with its steps undone) as a Function whose
own backward is the filter again.

Parameters are a dict of the published ``state_dict`` names under ``G.``
and ``D.`` (``G.mapping.fc0.weight``, ``D.b256.skip.weight``), float32 in
PyTorch's layouts; :func:`init_params` draws the published init from a
seed. Nothing here imports the program under test.

Departures from the published code:

- one card takes the 8-GPU global batch: the minibatch-stddev groups are
  strided over all 64 samples (eight GPUs group their own eight);
- the draws (real ids and flips, z, mixing z and cutoff, noise maps,
  path-length noise) come from the caller;
- ``noise_const``, ``resample_filter`` and ``nan_to_num`` on the gradients
  are left out (no non-finite gradient arises in a checked run);
- ``chunk`` samples at a time (whole mbstd groups) when the batch does not
  fit: the losses' gradients summed over the chunks; the path-length
  penalty's coupling through ``pl_mean`` carried as each sample's weight on
  its length, from a first pass over the whole batch.

``Precision("fp8")`` is the control, as in ``littlegan.py``: every conv's
input, weight and output held in float8 e4m3 with a per-tensor scale,
gradients through each rounding in e5m2. ``fault`` plants one of five
faults in the reference's place: ``no_demod`` (the demodulation dropped),
``pl_sign`` (the path-length loss's sign flipped), ``box_filter`` (a [1,
1, 1, 1] FIR in place of [1, 3, 3, 1]), ``no_mbstd`` (the stddev channel
zero) and ``no_lazy_ratio`` (both Adams at the plain lr and betas).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.littlegan import F32, Precision, no_tf32  # noqa: F401 (no_tf32: drivers/train_stylegan2.py's)

Params = Dict[str, torch.Tensor]
NETS = ("G", "D")
LOSSES = ("g_main", "pl_penalty", "d_fake", "d_real", "r1_penalty", "pl_mean")
FAULTS = ("no_demod", "pl_sign", "box_filter", "no_mbstd", "no_lazy_ratio")
SQRT2 = math.sqrt(2.0)
W_AVG_BETA = 0.995


# ----------------------------------------------------------------------- ops --


def lrelu(x):
    return torch.where(x.detach() > 0, x, 0.2 * x)


def bias_act(x, b, act: bool, gain: float, clamp: Optional[float]):
    if b is not None:
        x = x + b.reshape(1, -1, *([1] * (x.dim() - 2)))
    if act:
        x = lrelu(x) * SQRT2
    if gain != 1.0:
        x = x * gain
    return x if clamp is None else x.clamp(-clamp * gain, clamp * gain)


def _kernel(c: int, gain: float, taps, like):
    f = torch.tensor(taps, dtype=like.dtype, device=like.device)
    k = torch.outer(f, f)
    return (k / k.sum() * gain).flip([0, 1])[None, None].repeat(c, 1, 1, 1)


def _fir(x, up: int, down: int, pad: Tuple[int, int], gain: float, taps):
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h, up, w, up))
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(n, c, h * up, w * up)
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    return F.conv2d(x, _kernel(c, gain, taps, x), groups=c)[:, :, ::down, ::down]


def _fir_vjp(g, x_shape, args):
    """The adjoint of :func:`_fir` at ``g``, each of its steps undone in
    reverse: ``g`` spread over the filter's full output, the depthwise
    conv's transpose, the padding cropped, every ``up``-th pixel kept."""
    up, down, pad, gain, taps = args
    n, c, h, w = x_shape
    hp, wp = h * up + pad[0] + pad[1], w * up + pad[0] + pad[1]
    full = g.new_zeros((n, c, hp - 3, wp - 3))
    full[:, :, ::down, ::down] = g
    gp = F.conv_transpose2d(full, _kernel(c, gain, taps, g), groups=c)
    return gp[:, :, pad[0]:pad[0] + h * up:up, pad[0]:pad[0] + w * up:up]


class _Fir(torch.autograd.Function):
    """:func:`_fir`, whose backward is its vjp as a Function of its own
    (whose backward is :func:`_fir` again): a penalty's double backward then
    runs the first-order ops, where PyTorch's double backward of a
    depthwise conv runs one convolution per channel."""

    @staticmethod
    def forward(ctx, x, args):
        ctx.shape, ctx.args = x.shape, args
        return _fir(x, *args)

    @staticmethod
    def backward(ctx, g):
        return _FirVjp.apply(g, ctx.shape, ctx.args), None


class _FirVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x_shape, args):
        ctx.args = args
        return _fir_vjp(g, x_shape, args)

    @staticmethod
    def backward(ctx, gg):
        return _Fir.apply(gg, ctx.args), None, None


def fir(x, up: int, down: int, pad: Tuple[int, int], gain: float, taps=(1.0, 3.0, 3.0, 1.0)):
    """``upfirdn2d`` of (N, C, H, W): zero-insert by ``up``, pad ``pad`` on
    both axes, depthwise conv with the 4x4 outer product of ``taps`` over
    its sum (times ``gain``), keep every ``down``-th pixel."""
    return _Fir.apply(x, (up, down, pad, gain, tuple(taps)))


_WEIGHT_GRADS = [True]


@contextlib.contextmanager
def no_weight_gradients():
    """Inside: the convs' backwards form no weight gradient, as
    ``conv2d_gradfix.no_weight_gradients`` around a penalty's first backward."""
    _WEIGHT_GRADS[0] = False
    try:
        yield
    finally:
        _WEIGHT_GRADS[0] = True


class _Conv(torch.autograd.Function):
    """``conv2d`` (``transpose``: ``conv_transpose2d``) without bias whose
    input gradient is the other conv of the pair, so that a penalty's double
    backward runs as that conv's first-order backward, as the published
    ``conv2d_gradfix`` arranges (PyTorch's own double backward of a conv
    takes the weight's part as a convolution with an image-sized filter)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int, transpose: bool):
        ctx.save_for_backward(x, w)
        ctx.conf = stride, padding, transpose
        if transpose:
            return F.conv_transpose2d(x, w, stride=stride, padding=padding)
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, p, transpose = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            if transpose:
                gx = _Conv.apply(g, w, s, p, False)
            else:
                out = [x.shape[i] - ((g.shape[i] - 1) * s - 2 * p + w.shape[i]) for i in (2, 3)]
                gx = _ConvT.apply(g, w, s, p, out)
        if ctx.needs_input_grad[1] and _WEIGHT_GRADS[0]:
            gw = (torch.nn.grad.conv2d_weight(g, w.shape, x, stride=s, padding=p) if transpose
                  else torch.nn.grad.conv2d_weight(x, w.shape, g, stride=s, padding=p))
        return gx, gw, None, None, None


class _ConvT(torch.autograd.Function):
    """``conv_transpose2d`` with an output padding: :class:`_Conv`'s input gradient."""

    @staticmethod
    def forward(ctx, g, w, stride: int, padding: int, out):
        ctx.save_for_backward(g, w)
        ctx.conf = stride, padding
        return F.conv_transpose2d(g, w, stride=stride, padding=padding, output_padding=out)

    @staticmethod
    def backward(ctx, gg):
        g, w = ctx.saved_tensors
        s, p = ctx.conf
        ggrad = _Conv.apply(gg, w, s, p, False) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1] and _WEIGHT_GRADS[0]:
            gw = torch.nn.grad.conv2d_weight(gg, w.shape, g, stride=s, padding=p)
        return ggrad, gw, None, None, None


def conv2d(x, w, stride: int = 1, padding: int = 0, transpose: bool = False):
    return _Conv.apply(x, w, stride, padding, transpose)


def fc(x, w, b, lr_mul: float = 1.0, act: bool = False):
    y = F.linear(x, w * (lr_mul / math.sqrt(w.shape[1])), b * lr_mul)
    return lrelu(y) * SQRT2 if act else y


def mbstd(x, group: int, drop: bool = False):
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(g, n // g, 1, c, h, w)
    y = torch.sqrt(((y - y.mean(0)) ** 2).mean(0) + 1e-8).mean((2, 3, 4))  # (n // g, 1)
    y = y.reshape(n // g, 1, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, torch.zeros_like(y) if drop else y], 1)


# --------------------------------------------------------------------- model --


@dataclass
class Model:
    """The sizes G and D need, read from a configuration file."""

    image_dim: int = 256
    channel_base: int = 16384
    channel_max: int = 512
    z_dim: int = 512
    w_dim: int = 512
    mapping_layers: int = 8
    mapping_lr_mul: float = 0.01
    mbstd_group: int = 8
    conv_clamp: float = 256.0
    pr: Precision = field(default=F32)
    fault: Optional[str] = None

    @classmethod
    def from_config(cls, cfg: dict, pr: Precision = F32, fault: Optional[str] = None) -> "Model":
        keys = ("image_dim", "channel_base", "channel_max", "z_dim", "w_dim", "mapping_layers", "mapping_lr_mul",
                "mbstd_group", "conv_clamp")
        return cls(**{k: cfg[k] for k in keys if k in cfg}, pr=pr, fault=fault)

    def ch(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def res(self) -> List[int]:
        return [2 ** i for i in range(2, int(math.log2(self.image_dim)) + 1)]

    @property
    def num_ws(self) -> int:
        return 2 * len(self.res)

    @property
    def clamp(self) -> Optional[float]:
        return self.conv_clamp if self.conv_clamp > 0 else None

    def noise_sizes(self) -> List[int]:
        return [4] + [r for r in self.res[1:] for _ in range(2)]

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's name and shape, in the published modules' order."""
        out: Dict[str, Tuple[int, ...]] = {}
        for i in range(self.mapping_layers):
            out[f"G.mapping.fc{i}.weight"] = (self.w_dim, self.z_dim if i == 0 else self.w_dim)
            out[f"G.mapping.fc{i}.bias"] = (self.w_dim,)

        def layer(key, cin, cout):
            out[key + ".weight"] = (cout, cin, 3, 3)
            out[key + ".noise_strength"] = ()
            out[key + ".bias"] = (cout,)
            out[key + ".affine.weight"] = (cin, self.w_dim)
            out[key + ".affine.bias"] = (cin,)

        for res in self.res:
            key, c = f"G.synthesis.b{res}", self.ch(res)
            if res == 4:
                out[key + ".const"] = (c, 4, 4)
            else:
                layer(key + ".conv0", self.ch(res // 2), c)
            layer(key + ".conv1", c, c)
            out[key + ".torgb.weight"] = (3, c, 1, 1)
            out[key + ".torgb.bias"] = (3,)
            out[key + ".torgb.affine.weight"] = (c, self.w_dim)
            out[key + ".torgb.affine.bias"] = (c,)
        for res in self.res[:0:-1]:
            key, c, co = f"D.b{res}", self.ch(res), self.ch(res // 2)
            if res == self.image_dim:
                out[key + ".fromrgb.weight"], out[key + ".fromrgb.bias"] = (c, 3, 1, 1), (c,)
            out[key + ".conv0.weight"], out[key + ".conv0.bias"] = (c, c, 3, 3), (c,)
            out[key + ".conv1.weight"], out[key + ".conv1.bias"] = (co, c, 3, 3), (co,)
            out[key + ".skip.weight"] = (co, c, 1, 1)
        c = self.ch(4)
        out["D.b4.conv.weight"], out["D.b4.conv.bias"] = (c, c + 1, 3, 3), (c,)
        out["D.b4.fc.weight"], out["D.b4.fc.bias"] = (c, c * 16), (c,)
        out["D.b4.out.weight"], out["D.b4.out.bias"] = (1, c), (1,)
        return out

    def _fir(self, x, up, down, pad, gain=1.0):
        taps = (1.0, 1.0, 1.0, 1.0) if self.fault == "box_filter" else (1.0, 3.0, 3.0, 1.0)
        return fir(x, up, down, pad, gain, taps)

    def _conv(self, x, w, stride: int = 1, padding: int = 0, transpose: bool = False):
        pr = self.pr
        return pr.q(conv2d(pr.q(x), pr.q(w), stride, padding, transpose))

    # G
    def mapping(self, p: Params, z):
        x = z * torch.rsqrt((z * z).mean(1, keepdim=True) + 1e-8)
        for i in range(self.mapping_layers):
            x = fc(x, p[f"G.mapping.fc{i}.weight"], p[f"G.mapping.fc{i}.bias"], self.mapping_lr_mul, act=True)
        return x

    def _modconv(self, p: Params, key: str, x, w, noise, up: bool):
        wt = p[key + ".weight"]
        s = fc(w, p[key + ".affine.weight"], p[key + ".affine.bias"])
        wm = wt[None] * s[:, None, :, None, None]  # (N, O, I, k, k)
        d = torch.rsqrt(wm.square().sum((2, 3, 4)) + 1e-8)
        x = x * s[:, :, None, None]
        if up:
            y = self._conv(x, wt.transpose(0, 1), stride=2, transpose=True)
            y = self._fir(y, 1, 1, (1, 1), 4.0)
        else:
            y = self._conv(x, wt, padding=1)
        if self.fault != "no_demod":
            y = y * d[:, :, None, None]
        y = y + noise * p[key + ".noise_strength"]
        return bias_act(y, p[key + ".bias"], True, 1.0, self.clamp)

    def _torgb(self, p: Params, key: str, x, w):
        s = fc(w, p[key + ".affine.weight"], p[key + ".affine.bias"]) / math.sqrt(x.shape[1])
        y = self._conv(x * s[:, :, None, None], p[key + ".weight"])
        return bias_act(y, p[key + ".bias"], False, 1.0, self.clamp)

    def synthesis(self, p: Params, ws, noise):
        """(N, 3, H, W) images of (N, num_ws, w_dim) styles and (N, sum of res^2) noise maps."""
        n = ws.shape[0]
        maps, off = [], 0
        for r in self.noise_sizes():
            maps.append(noise[:, off:off + r * r].reshape(n, 1, r, r))
            off += r * r
        x = p["G.synthesis.b4.const"][None].repeat(n, 1, 1, 1)
        x = self._modconv(p, "G.synthesis.b4.conv1", x, ws[:, 0], maps[0], False)
        img = self._torgb(p, "G.synthesis.b4.torgb", x, ws[:, 1])
        for i, res in enumerate(self.res[1:], start=1):
            key = f"G.synthesis.b{res}"
            x = self._modconv(p, key + ".conv0", x, ws[:, 2 * i - 1], maps[2 * i - 1], True)
            x = self._modconv(p, key + ".conv1", x, ws[:, 2 * i], maps[2 * i], False)
            img = self._fir(img, 2, 1, (2, 1), 4.0) + self._torgb(p, key + ".torgb", x, ws[:, 2 * i + 1])
        return img

    # D
    def _dconv(self, p: Params, key: str, x, k: int, act: bool = True, down: bool = False, gain: float = 1.0,
               clamp: bool = True):
        w = p[key + ".weight"] / math.sqrt(p[key + ".weight"][0].numel())
        if down and k == 1:
            y = self._conv(self._fir(x, 1, 2, (1, 1)), w)
        elif down:
            y = self._conv(self._fir(x, 1, 1, (2, 2)), w, stride=2)
        else:
            y = self._conv(x, w, padding=k // 2)
        return bias_act(y, p.get(key + ".bias"), act, gain, self.clamp if clamp else None)

    def discriminator(self, p: Params, img):
        """(N,) logits."""
        x = None
        for res in self.res[:0:-1]:
            key = f"D.b{res}"
            if res == self.image_dim:
                x = self._dconv(p, key + ".fromrgb", img, 1)
            y = self._dconv(p, key + ".skip", x, 1, act=False, down=True, gain=math.sqrt(0.5), clamp=False)
            x = self._dconv(p, key + ".conv0", x, 3)
            x = y + self._dconv(p, key + ".conv1", x, 3, down=True, gain=math.sqrt(0.5))
        x = mbstd(x, self.mbstd_group, drop=self.fault == "no_mbstd")
        x = self._dconv(p, "D.b4.conv", x, 3)
        x = fc(x.flatten(1), p["D.b4.fc.weight"], p["D.b4.fc.bias"], act=True)
        return fc(x, p["D.b4.out.weight"], p["D.b4.out.bias"])[:, 0]


def init_params(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device, lr_mul: float = 0.01) -> Params:
    """The published init in ONE normal draw from ``gen``: every weight and
    the constant N(0, 1) (the mapping's N(0, 1 / lr_mul^2)), the affines'
    biases 1, every other bias and noise strength 0; float32 on ``device``."""
    drawn = {k: s for k, s in shapes.items() if k.endswith(".weight") or k.endswith(".const")}
    sizes = [math.prod(s) for s in drawn.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (k, s), n in zip(drawn.items(), sizes):
        out[k] = flat[off:off + n].view(s) / (lr_mul if k.startswith("G.mapping.") else 1.0)
        off += n
    for k, s in shapes.items():
        if k not in out:
            out[k] = torch.full(s, 1.0 if k.endswith(".affine.bias") else 0.0, device=device)
    return {k: out[k] for k in shapes}


# ------------------------------------------------------------------ training --


@dataclass
class Hyper:
    batch_size: int = 64
    lr: float = 0.0025
    beta_1: float = 0.0
    beta_2: float = 0.99
    r1_gamma: float = 1.0
    pl_weight: float = 2.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    style_mixing: float = 0.9
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    ema_kimg: float = 20.0

    @classmethod
    def from_config(cls, cfg: dict) -> "Hyper":
        return cls(**{k: cfg[k] for k in cls.__dataclass_fields__ if k in cfg})

    def interval(self, net: str) -> int:
        return self.g_reg_interval if net == "G" else self.d_reg_interval

    def runs(self, it: int) -> Tuple[bool, bool]:
        return (self.pl_weight != 0 and it % self.g_reg_interval == 0,
                self.r1_gamma != 0 and it % self.d_reg_interval == 0)


@dataclass
class Run:
    """What an iteration changes besides the parameters."""

    pl_mean: torch.Tensor
    w_avg: torch.Tensor
    ema: Optional[Params]


def adams(p: Params, hp: Hyper, fault: Optional[str] = None) -> Dict[str, torch.optim.Adam]:
    """``torch.optim.Adam`` of G and of D over ``p``'s tensors (leaves), with the lazy ratio."""
    out = {}
    for net in NETS:
        c = hp.interval(net) / (hp.interval(net) + 1) if fault != "no_lazy_ratio" else 1.0
        out[net] = torch.optim.Adam([v for k, v in p.items() if k.startswith(net + ".")], lr=hp.lr * c,
                                    betas=(hp.beta_1 ** c, hp.beta_2 ** c), eps=1e-8)
    return out


def leaves(p: Params) -> Params:
    """Copies of ``p`` that require gradients: the parameters an iteration updates in place."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


def new_run(p: Params, w_dim: int, ema: bool = True) -> Run:
    dev = next(iter(p.values())).device
    w_avg = torch.zeros(w_dim, device=dev)
    e = None
    if ema:
        e = {k: v.detach().clone() for k, v in p.items() if k.startswith("G.")}
        e["G.mapping.w_avg"] = w_avg.clone()
    return Run(torch.zeros((), device=dev), w_avg, e)


def chunks(n: int, group: int, size: Optional[int]) -> List[torch.Tensor]:
    """Index sets of ``size`` samples (all of them when None) made of whole
    minibatch-stddev groups ``{m + (n / g) j}``, ordered so that a chunk's
    own groups are the same."""
    g = min(group, n)
    k = n // g  # groups
    per = k if size is None or size >= n else max(1, size // g)
    out = []
    for m0 in range(0, k, per):
        ms = torch.arange(m0, min(m0 + per, k))
        out.append((ms[None, :] + k * torch.arange(g)[:, None]).reshape(-1))
    return out


def styles(model: Model, p: Params, d: dict, run: Run, hp: Hyper, idx=None):
    """(n, num_ws, w_dim) styles of a G pass over the samples ``idx`` (all
    of them when None); ``w_avg`` moves on the whole batch's w."""
    z, z2 = d["z"], d["z2"]
    if idx is None:
        with torch.no_grad():
            run.w_avg.copy_(torch.lerp(model.mapping(p, z).mean(0), run.w_avg, W_AVG_BETA))
        idx = torch.arange(z.shape[0], device=z.device)
    idx = idx.to(z.device)
    w = model.mapping(p, z[idx])[:, None].repeat(1, model.num_ws, 1)
    if hp.style_mixing > 0:
        w2 = model.mapping(p, z2[idx])
        cut = int(d["cutoff"])
        w = torch.cat([w[:, :cut], w2[:, None].repeat(1, model.num_ws - cut, 1)], 1)
    return w


def _step(p: Params, opts, net: str, loss_fns, grad_norms: Optional[dict] = None) -> None:
    """The summed gradients of ``loss_fns`` (one loss a chunk) into
    ``net``'s Adam, which steps (``opts`` None: gradients only, for the
    operation count). A leaf the gradient does not reach gets zeros, as the
    published losses' ``* 0`` terms give it."""
    keys = [k for k in p if k.startswith(net + ".")]
    others = [k for k in p if k not in keys]
    total: Dict[str, Optional[torch.Tensor]] = {k: None for k in keys}
    for k in others:  # the other network's requires_grad_(False), as the published phases set it
        p[k].requires_grad_(False)
    try:
        for fn in loss_fns:
            for k, g in zip(keys, torch.autograd.grad(fn(), [p[k] for k in keys], allow_unused=True)):
                if g is not None:
                    total[k] = g if total[k] is None else total[k] + g
    finally:
        for k in others:
            p[k].requires_grad_(True)
    for k in keys:
        if total[k] is None:
            total[k] = torch.zeros_like(p[k])
    if grad_norms is not None:
        for k in keys:
            grad_norms.setdefault(k, float(torch.linalg.vector_norm(total[k].double())))
    if opts is None:
        return
    for k in keys:
        p[k].grad = total[k]
    opts[net].step()
    for k in keys:
        p[k].grad = None


def _pl_lengths(model: Model, p: Params, d: dict, pl_noise, run: Run, hp: Hyper, idx, create_graph: bool):
    ws = styles(model, p, d, run, hp, idx)
    img = model.synthesis(p, ws, d["noise"][idx].float())
    n = pl_noise[idx] / math.sqrt(img.shape[2] * img.shape[3])
    with no_weight_gradients():
        (g,) = torch.autograd.grad((img * n).sum(), ws, create_graph=create_graph)
    return g.square().sum(2).mean(1).sqrt()


def g_reg(model: Model, p: Params, opts, run: Run, d: dict, pl_noise, hp: Hyper, chunk=None, fault=None,
          grad_norms=None) -> torch.Tensor:
    """Greg: the mean penalty; ``run.pl_mean`` moved on, G stepped."""
    nb = d["z"].shape[0]
    sign = -1.0 if fault == "pl_sign" else 1.0
    w = hp.pl_weight * hp.g_reg_interval * sign
    parts = chunks(nb, 1, chunk)  # G has no cross-sample term: any split
    if len(parts) == 1:
        with torch.no_grad():
            run.w_avg.copy_(torch.lerp(model.mapping(p, d["z"]).mean(0), run.w_avg, W_AVG_BETA))
        lengths = _pl_lengths(model, p, d, pl_noise, run, hp, parts[0], True)
        pl_mean = torch.lerp(run.pl_mean, lengths.mean(), hp.pl_decay)
        penalty = (lengths - pl_mean).square()
        _step(p, opts, "G", [lambda: (penalty * w).mean()], grad_norms)
    else:  # a first pass for pl_mean, then each chunk's lengths weighted by the penalty's derivative
        styles(model, p, d, run, hp)
        lengths = torch.cat([_pl_lengths(model, p, d, pl_noise, run, hp, i, False).detach() for i in parts])
        pl_mean = torch.lerp(run.pl_mean, lengths.mean(), hp.pl_decay)
        penalty = (lengths - pl_mean).square()
        coef = 2 * w / nb * ((lengths - pl_mean) - hp.pl_decay * (lengths - pl_mean).mean())
        order = torch.cat(parts)
        weight = {int(j): coef[i] for i, j in enumerate(order)}
        _step(p, opts, "G", [functools.partial(
            lambda i: (torch.stack([weight[int(j)] for j in i]) *
                       _pl_lengths(model, p, d, pl_noise, run, hp, i, True)).sum(), i) for i in parts], grad_norms)
    run.pl_mean.copy_(pl_mean.detach())
    return penalty.mean().detach()


def iteration(model: Model, p: Params, opts, run: Run, x_real, draws: dict, it: int, hp: Hyper,
              chunk: Optional[int] = None, fault: Optional[str] = None, grad_norms: Optional[dict] = None):
    """One iteration in place on ``p``, ``opts`` and ``run``: the (6,) terms
    (:data:`LOSSES`; 0 for a phase that does not run). ``x_real`` the (B,
    3, H, W) real images; ``draws``: ``g_main``, ``d_main`` and on Greg
    iterations ``g_reg`` (each ``z``, ``z2``, ``cutoff``, ``noise``) and
    ``pl_noise``. ``opts`` None: no update (counting). ``grad_norms`` gets
    each leaf's first gradient norm."""
    b = x_real.shape[0]
    parts = chunks(b, model.mbstd_group, chunk)
    zero = torch.zeros((), device=x_real.device)
    reg_g, reg_d = hp.runs(it)
    terms = []

    d = draws["g_main"]
    styles(model, p, d, run, hp)
    acc = []

    def gmain(i):
        loss = F.softplus(-model.discriminator(p, model.synthesis(p, styles(model, p, d, run, hp, i),
                                                                   d["noise"][i].float()))).sum() / b
        acc.append(loss.detach())
        return loss

    _step(p, opts, "G", [functools.partial(gmain, i) for i in parts], grad_norms)
    terms.append(sum(acc))
    terms.append(g_reg(model, p, opts, run, draws["g_reg"], draws["pl_noise"], hp, chunk, fault, grad_norms)
                 if reg_g else zero)

    d = draws["d_main"]
    styles(model, p, d, run, hp)
    fake_acc, real_acc = [], []

    def dmain(i):
        with torch.no_grad():
            img = model.synthesis(p, styles(model, p, d, run, hp, i), d["noise"][i].float())
        fake = F.softplus(model.discriminator(p, img)).sum() / b
        real = F.softplus(-model.discriminator(p, x_real[i])).sum() / b
        fake_acc.append(fake.detach())
        real_acc.append(real.detach())
        return fake + real

    _step(p, opts, "D", [functools.partial(dmain, i) for i in parts], grad_norms)
    terms += [sum(fake_acc), sum(real_acc)]

    if reg_d:
        pen_acc = []

        def dreg(i):
            x = x_real[i].detach().requires_grad_(True)
            with no_weight_gradients():
                (g,) = torch.autograd.grad(model.discriminator(p, x).sum(), x, create_graph=True)
            pen = g.square().sum((1, 2, 3))
            pen_acc.append(pen.detach().sum() / b)
            return (pen * (hp.r1_gamma / 2)).sum() / b * hp.d_reg_interval

        _step(p, opts, "D", [functools.partial(dreg, i) for i in parts], grad_norms)
        terms.append(sum(pen_acc))
    else:
        terms.append(zero)

    if run.ema is not None:
        beta = 0.5 ** (hp.batch_size / max(hp.ema_kimg * 1000, 1e-8))
        with torch.no_grad():
            for k, e in run.ema.items():
                e.copy_(run.w_avg if k == "G.mapping.w_avg" else torch.lerp(p[k], e, beta))
    terms.append(run.pl_mean.clone())
    return torch.stack([torch.as_tensor(t, device=x_real.device).detach().float() for t in terms])


# -------------------------------------------------------------- operations --


@functools.lru_cache(maxsize=8)
def _phase_flops(cfg_json: str) -> Tuple[float, float, float, float]:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    model, hp = Model.from_config(cfg), Hyper.from_config(cfg)
    b, dim = cfg["batch_size"], cfg["image_dim"]
    nb = b // hp.pl_batch_shrink
    meta = dict(device="meta")
    p = {k: torch.empty(s, **meta).requires_grad_(True) for k, s in model.shapes().items()}
    size = sum(r * r for r in model.noise_sizes())

    def g_draws(n):
        return {"z": torch.empty((n, model.z_dim), **meta), "z2": torch.empty((n, model.z_dim), **meta),
                "cutoff": model.num_ws // 2, "noise": torch.empty((n, size), **meta)}

    run = Run(torch.zeros((), **meta), torch.zeros(model.w_dim, **meta), None)
    x = torch.empty((b, 3, dim, dim), **meta)
    out = []
    for it in (1, 0):  # iteration 1 runs no regularisation, iteration 0 both
        with FlopCounterMode(display=False) as counter:
            iteration(model, p, None, run, x, {"g_main": g_draws(b), "d_main": g_draws(b), "g_reg": g_draws(nb),
                                               "pl_noise": torch.empty((nb, 3, dim, dim), **meta)}, it, hp)
        out.append(float(counter.get_total_flops()))
    with FlopCounterMode(display=False) as counter:
        g_reg(model, p, None, run, g_draws(nb), torch.empty((nb, 3, dim, dim), **meta), hp)
    greg = float(counter.get_total_flops())
    main = out[0]
    dreg = out[1] - main - greg
    return main, greg, dreg, main + greg / hp.g_reg_interval + dreg / hp.d_reg_interval


def phase_flops(cfg: dict) -> Dict[str, float]:
    """Operations of the phases as the published code runs them (every tap
    of every convolution and matrix product, forwards and the gradients the
    phases take): ``main`` (Gmain + Dmain), ``g_reg``, ``d_reg``, and
    ``iteration``, one iteration averaged over the lazy period."""
    main, greg, dreg, avg = _phase_flops(json.dumps(cfg, sort_keys=True))
    if not all(math.isfinite(v) and v > 0 for v in (main, greg, dreg, avg)):
        raise ValueError(f"no operations counted for {cfg.get('image_dim')}")
    return {"main": main, "g_reg": greg, "d_reg": dreg, "iteration": avg}


def iteration_flops(cfg: dict) -> float:
    """Operations of one iteration averaged over the lazy period."""
    return phase_flops(cfg)["iteration"]
