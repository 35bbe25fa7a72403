"""StyleGAN2 (Karras et al., CVPR 2020, arXiv:1912.04958) as ``nn.Module``s:
``training/networks.py`` of github.com/NVlabs/stylegan2-ada-pytorch with
the ``skip`` generator and the ``resnet`` discriminator of its
``paper256`` configuration.

:class:`StyleGAN2` holds ``G`` and ``D``; a parameter's name under each is
the published ``state_dict`` key (``G.mapping.fc0.weight``,
``G.synthesis.b8.conv0.affine.bias``, ``D.b256.skip.weight``):

- :class:`MappingNetwork`: z normalised by its second moment, then
  ``mapping_layers`` equalized-lr FCs with ``lr_mul`` 0.01 (the published
  value, a constant here) and
  ``lrelu(0.2) * sqrt(2)``; ``w_avg`` (a buffer) tracked with beta 0.995 in
  training. The caller broadcasts w to the ``num_ws`` layers and mixes
  styles (``training/stylegan2.py``).
- :class:`SynthesisNetwork`: a learned 4x4 constant, then per resolution
  from 8 to ``image_dim`` ``conv0`` (a modulated 3x3 transposed stride-2
  conv, then the FIR filter with gain 4), ``conv1`` (a modulated 3x3) and
  ``torgb`` (a modulated 1x1 without demodulation, style gain
  ``1/sqrt(cin)``); the image is ``upsample2d(img) + torgb(x)`` in
  float32. A modulated layer runs the published non-fused form: ``x *
  s[n, i]``, the shared-weight conv, ``* d[n, o]`` with ``d = rsqrt(sum_{i,
  k} (W[o, i, k] s[n, i])^2 + 1e-8)`` (formed as ``s^2 @ sum_k W^2``), plus
  ``noise * noise_strength``, then the bias (``ops/cuda/conv_epilogue.py``,
  S3) and ``clamp(lrelu(.) * sqrt(2), +-CONV_CLAMP)``.
- :class:`Discriminator`: ``fromrgb`` (1x1) at the top resolution, then per
  resolution ``conv0`` (3x3), ``conv1`` (the FIR filter over the map padded
  by 2, then a 3x3 stride-2 conv; activation gain ``sqrt(0.5)``) and
  ``skip`` (the FIR filter with stride 2, then a 1x1 without bias, linear,
  times ``sqrt(0.5)``), the block's output ``skip + conv1``; the 4x4
  epilogue in float32: minibatch stddev (groups of ``mbstd_group``
  samples strided over the batch, one channel), a 3x3 conv, an FC to 512
  and an FC to one logit.

Every weight uses equalized lr (its runtime gain ``lr_mul / sqrt(fan_in)``,
the bias's ``lr_mul``), except the modulated convs' weights, which the
demodulation normalises. The FIR resampling is ``ops/cuda/upfirdn2d.py``'s
(S4: a CUDA kernel on the card, its plain version on the CPU). Every conv
of G and D, and every LeakyReLU of D, is ``ops/gradfix.py``'s first-order
form, so the path-length penalty's and R1's double backwards run as
first-order convs and send nothing back into the forward's graph.

Parameters are float32. Convolutions run in ``cfg.compute_dtype`` over
channels-last maps (every conv weight lies channels-last, as its Adam
moments and EMA then do); the mapping, the affines, the demodulation
coefficients, the image and D's 4x4 epilogue stay float32, as published.
Departures: bf16 at every resolution from 4 to 256 (the published code
runs fp16 on the top four and float32 below, with a pre-normalisation of
fp16 weights that bf16's range does not need); the ``noise_const`` and
``resample_filter`` buffers are left out (training draws its noise, and
the filter is fixed in S4). :func:`init_params` is the published init from
a seed. Counters ``stylegan2.mapping``, ``.synthesis``, ``.discriminator``:
one per network call. :func:`check_supported` refuses the options this
model does not have.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.ops.cuda._build import LaunchCounter
from littlegan_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue
from littlegan_tpu_torch.ops.cuda.upfirdn2d import downsample2d, upfirdn2d, upsample2d
from littlegan_tpu_torch.ops.gradfix import R1Conv, R1ConvTranspose, r1_leaky_relu

CALLS = {name: LaunchCounter(f"stylegan2.{name}") for name in ("mapping", "synthesis", "discriminator")}
LAYOUT = torch.channels_last
SQRT2 = math.sqrt(2.0)
ALPHA = 0.2
W_AVG_BETA = 0.995
MAPPING_LR_MUL = 0.01
CONV_CLAMP = 256.0  # bias_act's clamp of every conv layer but D's skips
PL_BATCH_SHRINK = 2  # the path-length penalty's batch: B / 2


def check_supported(cfg: Config) -> None:
    """Refuse what StyleGAN2 does not run: the LittleGAN layout, the
    LittleGAN-only penalty and remat, every form of parallelism or
    accumulation, and sizes the networks cannot take."""
    refused = [
        (cfg.use_s2d, "use_s2d: the space-to-depth boundary is LittleGAN's 5x5 layout; set use_s2d false"),
        (cfg.use_gp, "use_gp: StyleGAN2's penalties are R1 and path length, always on"),
        (cfg.remat, "remat: not built for StyleGAN2"),
        (cfg.mesh_shape is not None or cfg.shard_opt_state or cfg.shard_dense
         or int(os.environ.get("WORLD_SIZE", "1")) > 1,
         "a mesh, sharding or several processes: StyleGAN2 trains on one card (data parallelism is queued)"),
        (cfg.grad_accum > 1, "grad_accum > 1: one iteration is up to four optimizer phases on one batch"),
    ]
    bad = [why for on, why in refused if on]
    if bad:
        raise ValueError("model stylegan2 does not support " + "; ".join(bad))
    if cfg.image_dim < 8 or cfg.image_dim & (cfg.image_dim - 1):
        raise ValueError(f"stylegan2 needs a power-of-two image_dim >= 8, got {cfg.image_dim}")
    if cfg.batch_size % min(cfg.mbstd_group, cfg.batch_size):
        raise ValueError(f"stylegan2: batch_size {cfg.batch_size} is not a multiple of mbstd_group {cfg.mbstd_group}")
    if cfg.batch_size < PL_BATCH_SHRINK:
        raise ValueError(f"stylegan2: batch_size {cfg.batch_size} leaves no path-length batch")


def resolutions(image_dim: int) -> List[int]:
    """The synthesis blocks' resolutions, 4 up to ``image_dim``."""
    return [2 ** i for i in range(2, int(math.log2(image_dim)) + 1)]


def channels(cfg: Config, res: int) -> int:
    return min(cfg.channel_base // res, cfg.channel_max)


def num_ws(image_dim: int) -> int:
    """Style vectors the synthesis reads: two a block, the last ToRGB's one more."""
    return 2 * len(resolutions(image_dim))


def noise_sizes(image_dim: int) -> List[int]:
    """The resolution of each modulated layer's noise, in layer order."""
    out = [4]
    for res in resolutions(image_dim)[1:]:
        out += [res, res]
    return out


def bias_act(x: torch.Tensor, bias: Optional[torch.Tensor], act: bool, gain: float, clamp: Optional[float]):
    """``bias_act``: the bias (S3), then ``lrelu(0.2) * sqrt(2) * gain`` (or
    ``* gain``), clamped at ``+-clamp * gain``."""
    if bias is not None:
        x = conv_epilogue(x.contiguous(memory_format=LAYOUT), bias)
    if act:
        x = r1_leaky_relu(x, ALPHA) * (SQRT2 * gain)
    elif gain != 1.0:
        x = x * gain
    return x if clamp is None else x.clamp(-clamp * gain, clamp * gain)


class FC(nn.Module):
    """``FullyConnectedLayer``: ``weight`` drawn N(0, 1 / lr_mul^2), applied
    times ``lr_mul / sqrt(in)``; ``bias`` times ``lr_mul``; computes in its
    input's dtype."""

    def __init__(self, cin: int, cout: int, bias_init: float = 0.0, lr_mul: float = 1.0, act: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin) / lr_mul)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_init)))
        self.weight_gain, self.bias_gain, self.act = lr_mul / math.sqrt(cin), lr_mul, act

    def forward(self, x):
        y = F.linear(x, (self.weight * self.weight_gain).to(x.dtype), (self.bias * self.bias_gain).to(x.dtype))
        return r1_leaky_relu(y, ALPHA) * SQRT2 if self.act else y


class MappingNetwork(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.n = cfg.mapping_layers
        for i in range(self.n):
            setattr(self, f"fc{i}", FC(cfg.z_dim if i == 0 else cfg.w_dim, cfg.w_dim, lr_mul=MAPPING_LR_MUL,
                                       act=True))
        self.register_buffer("w_avg", torch.zeros(cfg.w_dim))

    def forward(self, z: torch.Tensor, update_w_avg: bool = False) -> torch.Tensor:
        """(N, w_dim) float32 w of (N, z_dim) z; with ``update_w_avg``, the
        batch's mean w moved into ``w_avg`` (``lerp(mean, w_avg, 0.995)``)."""
        CALLS["mapping"].add()
        x = z.float()
        x = x * (x.square().mean(1, keepdim=True) + 1e-8).rsqrt()
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
        if update_w_avg:
            with torch.no_grad():
                self.w_avg.copy_(x.detach().mean(0).lerp(self.w_avg, W_AVG_BETA))
        return x


def modulate(x: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    return x * styles.to(x.dtype)[:, :, None, None]


class SynthesisLayer(nn.Module):
    """A modulated 3x3 conv (``up`` 2: transposed stride 2, then the FIR
    filter) with noise, bias and ``lrelu``, clamped."""

    def __init__(self, cin: int, cout: int, w_dim: int, up: int):
        super().__init__()
        self.affine = FC(w_dim, cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(cout, cin, 3, 3).contiguous(memory_format=LAYOUT))
        self.noise_strength = nn.Parameter(torch.zeros([]))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.up = up

    def forward(self, x, w, noise):
        styles = self.affine(w)
        wt = self.weight
        d = (styles.square() @ wt.square().sum((2, 3)).t() + 1e-8).rsqrt()
        x = modulate(x, styles)
        if self.up == 2:
            y = R1ConvTranspose.apply(x, wt.transpose(0, 1).to(x.dtype), 2)
            y = upfirdn2d(y, 1, 1, 1, 1, 4.0)
        else:
            y = R1Conv.apply(x, wt.to(x.dtype), 1)
        y = y * d.to(y.dtype)[:, :, None, None] + (noise.float() * self.noise_strength).to(y.dtype)
        return bias_act(y, self.bias, True, 1.0, CONV_CLAMP)


class ToRGB(nn.Module):
    def __init__(self, cin: int, w_dim: int, channels: int = 3):
        super().__init__()
        self.affine = FC(w_dim, cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(channels, cin, 1, 1).contiguous(memory_format=LAYOUT))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.weight_gain = 1.0 / math.sqrt(cin)

    def forward(self, x, w):
        y = R1Conv.apply(modulate(x, self.affine(w) * self.weight_gain), self.weight.to(x.dtype), 0)
        return bias_act(y, self.bias, False, 1.0, CONV_CLAMP)


class SynthesisBlock(nn.Module):
    def __init__(self, cin: int, cout: int, w_dim: int, res: int):
        super().__init__()
        self.res = res
        if cin == 0:
            self.const = nn.Parameter(torch.randn(cout, res, res))
        else:
            self.conv0 = SynthesisLayer(cin, cout, w_dim, 2)
        self.conv1 = SynthesisLayer(cout, cout, w_dim, 1)
        self.torgb = ToRGB(cout, w_dim)

    def forward(self, x, img, ws: Sequence[torch.Tensor], noises: Sequence[torch.Tensor], dtype):
        """ws: this block's (conv0,) conv1, torgb styles; noises: its layers' maps."""
        if x is None:
            x = self.const.to(dtype).unsqueeze(0).expand(ws[0].shape[0], -1, -1, -1).contiguous(memory_format=LAYOUT)
            x = self.conv1(x, ws[0], noises[0])
        else:
            x = self.conv0(x, ws[0], noises[0])
            x = self.conv1(x, ws[1], noises[1])
        y = self.torgb(x, ws[-1]).float()
        return x, (y if img is None else upsample2d(img) + y)


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.res = resolutions(cfg.image_dim)
        for res in self.res:
            cin = 0 if res == 4 else channels(cfg, res // 2)
            setattr(self, f"b{res}", SynthesisBlock(cin, channels(cfg, res), cfg.w_dim, res))

    def forward(self, ws: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) float32 images (channels-last) of (N, num_ws, w_dim)
        styles and (N, sum of the layers' res^2) noise, the layers' maps
        one after the other."""
        CALLS["synthesis"].add()
        n = ws.shape[0]
        maps, off = [], 0
        for r in noise_sizes(self.res[-1]):
            maps.append(noise[:, off:off + r * r].view(n, 1, r, r))
            off += r * r
        w = ws.float().unbind(1)
        x = img = None
        for i, res in enumerate(self.res):
            block = getattr(self, f"b{res}")
            if i == 0:
                x, img = block(x, img, (w[0], w[1]), maps[:1], self.dtype)
            else:
                x, img = block(x, img, w[2 * i - 1:2 * i + 2], maps[2 * i - 1:2 * i + 1], self.dtype)
        return img


class Generator(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.mapping = MappingNetwork(cfg)
        self.synthesis = SynthesisNetwork(cfg)


class DConv(nn.Module):
    """``Conv2dLayer``: an equalized-lr conv (``down`` 2: the FIR filter,
    then stride 2), the bias (or none), ``lrelu`` or linear, clamped."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True, act: bool = True, down: int = 1,
                 clamp: Optional[float] = CONV_CLAMP):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k).contiguous(memory_format=LAYOUT))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.weight_gain = 1.0 / math.sqrt(cin * k * k)
        self.k, self.act, self.down, self.clamp = k, act, down, clamp

    def forward(self, x, gain: float = 1.0):
        w = (self.weight * self.weight_gain).to(x.dtype)
        if self.down == 2 and self.k == 1:
            y = R1Conv.apply(downsample2d(x), w, 0)
        elif self.down == 2:
            y = R1Conv.apply(upfirdn2d(x, 1, 1, 2, 2), w, 0, 2)
        else:
            y = R1Conv.apply(x, w, self.k // 2)
        return bias_act(y, self.bias, self.act, gain, self.clamp)


class DiscriminatorBlock(nn.Module):
    def __init__(self, cin: int, cout: int, first: bool, channels: int = 3):
        super().__init__()
        if first:
            self.fromrgb = DConv(channels, cin, 1)
        self.conv0 = DConv(cin, cin, 3)
        self.conv1 = DConv(cin, cout, 3, down=2)
        self.skip = DConv(cin, cout, 1, bias=False, act=False, down=2, clamp=None)

    def forward(self, x):
        if hasattr(self, "fromrgb"):
            x = self.fromrgb(x)
        y = self.skip(x, gain=math.sqrt(0.5))
        return y + self.conv1(self.conv0(x), gain=math.sqrt(0.5))


def minibatch_std(x: torch.Tensor, group: int) -> torch.Tensor:
    """``MinibatchStdLayer`` with one channel: each sample's group is the
    samples ``n % (N / G)`` alike (``x.reshape(G, -1, ...)``)."""
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.reshape(g, -1, 1, c, h, w)
    y = (y - y.mean(0)).square().mean(0)
    y = (y + 1e-8).sqrt().mean((2, 3, 4)).reshape(-1, 1, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y], 1)


class DiscriminatorEpilogue(nn.Module):
    def __init__(self, c: int, res: int, mbstd_group: int):
        super().__init__()
        self.group = mbstd_group
        self.conv = DConv(c + 1, c, 3)
        self.fc = FC(c * res * res, c, act=True)
        self.out = FC(c, 1)

    def forward(self, x):
        x = minibatch_std(x.float().contiguous(), self.group)
        return self.out(self.fc(self.conv(x.contiguous(memory_format=LAYOUT)).flatten(1)))


class Discriminator(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.res = resolutions(cfg.image_dim)[:0:-1]  # the blocks' resolutions, the top one first
        for res in self.res:
            setattr(self, f"b{res}", DiscriminatorBlock(channels(cfg, res), channels(cfg, res // 2),
                                                        res == cfg.image_dim))
        self.b4 = DiscriminatorEpilogue(channels(cfg, 4), 4, cfg.mbstd_group)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """(N,) float32 logits of (N, 3, H, W) images."""
        CALLS["discriminator"].add()
        x = img.to(self.dtype, memory_format=LAYOUT)
        for res in self.res:
            x = getattr(self, f"b{res}")(x)
        return self.b4(x).squeeze(1)


class StyleGAN2(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        check_supported(cfg)
        self.G = Generator(cfg)
        self.D = Discriminator(cfg)


@torch.no_grad()
def init_params(model: StyleGAN2, seed: int) -> StyleGAN2:
    """The published init in place, from ``seed`` (one CPU generator, the
    parameters in order): every weight and the constant N(0, 1) (an
    equalized-lr FC's over ``lr_mul``), biases 0 (the affines' 1),
    noise strengths 0; ``w_avg`` 0."""
    gen = torch.Generator().manual_seed(seed)
    fcs = {name: m for name, m in model.named_modules() if isinstance(m, FC)}
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        if leaf == "weight" or leaf == "const":
            lr_mul = fcs[owner].bias_gain if owner in fcs else 1.0
            p.copy_(torch.randn(p.shape, generator=gen) / lr_mul)
        elif leaf == "bias":
            p.fill_(1.0 if owner.endswith("affine") else 0.0)
        else:
            p.zero_()
    model.G.mapping.w_avg.zero_()
    return model
