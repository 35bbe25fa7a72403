"""StarGAN v2 (Choi et al., CVPR 2020, arXiv:1912.01865) as ``nn.Module``s:
``core/model.py`` of github.com/clovaai/stargan-v2 with ``w_hpf = 0``.

:class:`StarGANv2` holds the four networks under their published names,
so a parameter's name is the published ``state_dict`` key under its
network (``generator.encode.0.conv1.weight``):

- :class:`Generator`: a 3x3 ``from_rgb``, ``log2(image_dim) - 4``
  downsampling :class:`ResBlk` (affine IN) and two bottleneck ones, the
  mirrored :class:`AdainResBlk` (AdaIN from the 64-d style, nearest x2
  upsampling), ``to_rgb`` (affine IN, LeakyReLU, 1x1 conv; its modules
  named ``0`` and ``2`` as the published ``nn.Sequential``'s);
- :class:`MappingNetwork`: four shared ``mapping_dim`` linears with ReLU,
  then per domain three more and a ``style_dim`` output;
- :class:`StyleEncoder` and :class:`Discriminator`: a 3x3 conv,
  ``log2(image_dim) - 2`` downsampling blocks without norm, LeakyReLU, a
  4x4 valid conv, LeakyReLU, and per domain a linear to a style
  (encoder) or a 1x1 conv to one logit per domain (discriminator).

Every per-domain head is computed, and each sample's row gathered by its
label on the card (:func:`pick`), as the published code does: every head
then takes part in every Adam step of its network, with a zero gradient
where no sample chose it. Every biased convolution ends in one call of
``ops/cuda/conv_epilogue.py``'s epilogue (a CUDA kernel on the card, its
plain version on the CPU): its float32 bias added to the output, and in a
residual block's second conv the shortcut added and the sum divided by
sqrt(2) in the same pass; its backward forms the bias gradient as a
float32 column sum. Every norm is followed by a LeakyReLU, and the two run
as one call of ``ops/cuda/channel_norm_lrelu.py``'s per-(sample, channel)
instance norm (eps 1e-5) + LeakyReLU: a CUDA kernel on the card, its plain
version on the CPU. Resampling is ``ops/resample.py``'s (a CUDA kernel on
the card too). The discriminator's convs and LeakyReLUs are :class:`R1Conv` and
``ops/gradfix.py``'s :func:`r1_leaky_relu`: the same arithmetic, with
backwards that R1's double backward differentiates in cuDNN's first-order
kernels and that send nothing back into the forward's graph.

Parameters are float32; every network takes (B, 3, H, W) images, casts
them to ``cfg.compute_dtype`` in channels-last memory (:data:`LAYOUT`) and
computes convolutions, linears and norms in it (norm statistics and affine
in float32); outputs stay in the compute dtype and layout. Every
activation, and every conv weight from its creation (so its Adam moments,
its EMA and its gradient too), lies channels-last, so that cuDNN's kernels
read and write them as they are.
:func:`init_params` is the published ``he_init`` from a seed. Each network
counts its calls (``stargan_v2.generator``, ``.mapping``,
``.style_encoder``, ``.discriminator``: ``ops/cuda/_build.py``'s
``LaunchCounter``s, which a CUDA graph's replays advance). No LittleGAN
kernel of ``ops/cuda`` runs here. :func:`check_supported` refuses the
options this model does not have.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.ops.cuda._build import LaunchCounter
from littlegan_tpu_torch.ops.cuda.channel_norm_lrelu import channel_norm_lrelu
from littlegan_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue
from littlegan_tpu_torch.ops.gradfix import R1Conv as _R1Conv
from littlegan_tpu_torch.ops.gradfix import r1_leaky_relu
from littlegan_tpu_torch.ops.resample import downsample, upsample

CALLS = {name: LaunchCounter(f"stargan_v2.{name}")
         for name in ("generator", "mapping", "style_encoder", "discriminator")}
SQRT2 = math.sqrt(2.0)
LAYOUT = torch.channels_last  # the memory format of every activation and conv weight


def check_supported(cfg: Config) -> None:
    """Refuse what StarGAN v2 does not run: the LittleGAN layout, the
    LittleGAN-only penalty and remat, and every form of parallelism or
    accumulation."""
    refused = [
        (cfg.use_s2d, "use_s2d: the space-to-depth boundary is LittleGAN's 5x5 layout; set use_s2d false"),
        (cfg.use_gp, "use_gp: StarGAN v2's penalty is R1 (lambda_reg), always on"),
        (cfg.remat, "remat: not built for StarGAN v2"),
        (cfg.mesh_shape is not None or cfg.shard_opt_state or cfg.shard_dense
         or int(os.environ.get("WORLD_SIZE", "1")) > 1,
         "a mesh, sharding or several processes: StarGAN v2 trains on one card (data parallelism is queued)"),
        (cfg.grad_accum > 1, "grad_accum > 1: one iteration is four optimizer phases on one batch"),
    ]
    bad = [why for on, why in refused if on]
    if bad:
        raise ValueError("model stargan_v2 does not support " + "; ".join(bad))
    if cfg.image_dim < 32 or cfg.image_dim & (cfg.image_dim - 1):
        raise ValueError(f"stargan_v2 needs a power-of-two image_dim >= 32, got {cfg.image_dim}")


def pick(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Each sample's row of a (B, domains, ...) output, by its label (on the card)."""
    idx = y.view(-1, 1, *([1] * (out.dim() - 2))).expand(-1, 1, *out.shape[2:])
    return out.gather(1, idx).squeeze(1)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (float32 parameters),
    its weight held in :data:`LAYOUT`. ``forward(x, sc, s)``: the
    convolution without its bias, then :func:`conv_epilogue`: ``s * (conv(x)
    + bias + sc)`` (a residual block's second conv: its shortcut and 1/sqrt(2))."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.weight = nn.Parameter(self.weight.detach().contiguous(memory_format=LAYOUT))

    def conv(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)

    def forward(self, x, sc=None, s: float = 1.0):
        y = self.conv(x)
        return y if self.bias is None else conv_epilogue(y, self.bias, sc, s)


class R1Conv(Conv):
    """The discriminator's convs (stride 1): ``ops/gradfix.py``'s :class:`R1Conv`, then the
    epilogue (whose backward, and its backward, are kernels too)."""

    def conv(self, x):
        return _R1Conv.apply(x, self.weight.to(x.dtype), self.padding[0])


class R1LeakyReLU(nn.LeakyReLU):
    def forward(self, x):
        return r1_leaky_relu(x, self.negative_slope)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (float32 parameters)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d(c, affine=True)`` and the LeakyReLU after it: the
    weight and bias as published."""

    def __init__(self, c: int, alpha: float):
        super().__init__()
        self.alpha = alpha
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return channel_norm_lrelu(x, self.weight, self.bias, self.alpha)


class ResBlk(nn.Module):
    """``r1``: the discriminator's form (:class:`R1Conv`, :func:`r1_leaky_relu`)."""

    def __init__(self, cin: int, cout: int, alpha: float, normalize: bool = False, down: bool = False,
                 r1: bool = False):
        super().__init__()
        self.alpha, self.normalize, self.down = alpha, normalize, down
        self.act = r1_leaky_relu if r1 else F.leaky_relu
        conv = R1Conv if r1 else Conv
        self.conv1 = conv(cin, cin, 3, 1, 1)
        self.conv2 = conv(cin, cout, 3, 1, 1)
        if normalize:
            self.norm1, self.norm2 = InstanceNorm(cin, alpha), InstanceNorm(cin, alpha)
        self.conv1x1 = conv(cin, cout, 1, 1, 0, bias=False) if cin != cout else None

    def forward(self, x):
        sc = x if self.conv1x1 is None else self.conv1x1(x)
        if self.down:
            sc = downsample(sc)
        r = self.conv1(self.norm1(x) if self.normalize else self.act(x, self.alpha))
        if self.down:
            r = downsample(r)
        return self.conv2(self.norm2(r) if self.normalize else self.act(r, self.alpha), sc, 1.0 / SQRT2)


class AdaIN(nn.Module):
    """AdaIN, ``(1 + gamma) * IN(x) + beta`` with (gamma, beta) a linear of
    the style, and the LeakyReLU after it."""

    def __init__(self, style_dim: int, c: int, alpha: float):
        super().__init__()
        self.alpha = alpha
        self.fc = Linear(style_dim, 2 * c)

    def forward(self, x, s):
        gamma, beta = self.fc(s).float().chunk(2, dim=1)
        return channel_norm_lrelu(x, gamma, beta, self.alpha, offset=1.0)


class AdainResBlk(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int, alpha: float, up: bool = False):
        super().__init__()
        self.up = up
        self.conv1 = Conv(cin, cout, 3, 1, 1)
        self.conv2 = Conv(cout, cout, 3, 1, 1)
        self.norm1, self.norm2 = AdaIN(style_dim, cin, alpha), AdaIN(style_dim, cout, alpha)
        self.conv1x1 = Conv(cin, cout, 1, 1, 0, bias=False) if cin != cout else None

    def forward(self, x, s):
        r = self.norm1(x, s)
        if self.up:
            r = upsample(r)
        r = self.norm2(self.conv1(r), s)
        sc = upsample(x) if self.up else x
        if self.conv1x1 is not None:
            sc = self.conv1x1(sc)
        return self.conv2(r, sc, 1.0 / SQRT2)


def widths(cfg: Config, repeat: int) -> List[Tuple[int, int]]:
    """(in, out) of ``repeat`` downsampling blocks from the first width."""
    out, d = [], cfg.base_dim or 2 ** 14 // cfg.image_dim
    for _ in range(repeat):
        out.append((d, min(2 * d, cfg.max_conv_dim)))
        d = out[-1][1]
    return out


class _Net(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.dtype = getattr(torch, cfg.compute_dtype)


class Generator(_Net):
    def __init__(self, cfg: Config):
        super().__init__(cfg)
        a = cfg.leaky_alpha
        down = widths(cfg, int(math.log2(cfg.image_dim)) - 4)
        top, d = down[-1][1], down[0][0]
        self.from_rgb = Conv(3, d, 3, 1, 1)
        self.encode = nn.ModuleList([ResBlk(i, o, a, normalize=True, down=True) for i, o in down]
                                    + [ResBlk(top, top, a, normalize=True) for _ in range(2)])
        self.decode = nn.ModuleList([AdainResBlk(top, top, cfg.style_dim, a) for _ in range(2)]
                                    + [AdainResBlk(o, i, cfg.style_dim, a, up=True) for i, o in reversed(down)])
        # the published Sequential(IN, LeakyReLU, conv): the LeakyReLU runs inside the norm's call
        self.to_rgb = nn.Sequential(OrderedDict([("0", InstanceNorm(d, a)), ("2", Conv(d, 3, 1, 1, 0))]))

    def forward(self, x, s):
        CALLS["generator"].add()
        x = self.from_rgb(x.to(self.dtype, memory_format=LAYOUT))
        for block in self.encode:
            x = block(x)
        s = s.to(self.dtype)
        for block in self.decode:
            x = block(x, s)
        return self.to_rgb(x)


class MappingNetwork(_Net):
    def __init__(self, cfg: Config):
        super().__init__(cfg)
        m = cfg.mapping_dim
        layers: List[nn.Module] = [Linear(cfg.latent_dim, m), nn.ReLU()]
        for _ in range(3):
            layers += [Linear(m, m), nn.ReLU()]
        self.shared = nn.Sequential(*layers)
        self.unshared = nn.ModuleList([
            nn.Sequential(Linear(m, m), nn.ReLU(), Linear(m, m), nn.ReLU(), Linear(m, m), nn.ReLU(),
                          Linear(m, cfg.style_dim))
            for _ in range(cfg.num_domains)])

    def forward(self, z, y):
        CALLS["mapping"].add()
        h = self.shared(z.to(self.dtype))
        return pick(torch.stack([head(h) for head in self.unshared], 1), y)


def _trunk(cfg: Config, r1: bool = False) -> List[nn.Module]:
    """The style encoder's and the discriminator's shared layers (``r1``: the discriminator's)."""
    a = cfg.leaky_alpha
    blocks = widths(cfg, int(math.log2(cfg.image_dim)) - 2)
    top = blocks[-1][1]
    conv, act = (R1Conv, R1LeakyReLU) if r1 else (Conv, nn.LeakyReLU)
    return ([conv(3, blocks[0][0], 3, 1, 1)] + [ResBlk(i, o, a, down=True, r1=r1) for i, o in blocks]
            + [act(a), conv(top, top, 4, 1, 0), act(a)])


class StyleEncoder(_Net):
    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.shared = nn.Sequential(*_trunk(cfg))
        top = widths(cfg, int(math.log2(cfg.image_dim)) - 2)[-1][1]
        self.unshared = nn.ModuleList([Linear(top, cfg.style_dim) for _ in range(cfg.num_domains)])

    def forward(self, x, y):
        CALLS["style_encoder"].add()
        h = self.shared(x.to(self.dtype, memory_format=LAYOUT)).flatten(1)
        return pick(torch.stack([head(h) for head in self.unshared], 1), y)


class Discriminator(_Net):
    def __init__(self, cfg: Config):
        super().__init__(cfg)
        top = widths(cfg, int(math.log2(cfg.image_dim)) - 2)[-1][1]
        self.main = nn.Sequential(*_trunk(cfg, r1=True), R1Conv(top, cfg.num_domains, 1, 1, 0))

    def forward(self, x, y):
        CALLS["discriminator"].add()
        return pick(self.main(x.to(self.dtype, memory_format=LAYOUT)).flatten(1), y)


class StarGANv2(nn.Module):
    """The four networks, each the prefix of its parameters' names."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_supported(cfg)
        self.generator = Generator(cfg)
        self.mapping_network = MappingNetwork(cfg)
        self.style_encoder = StyleEncoder(cfg)
        self.discriminator = Discriminator(cfg)


@torch.no_grad()
def init_params(model: StarGANv2, seed: int) -> StarGANv2:
    """The published ``he_init`` in place, from ``seed`` (one CPU generator,
    the parameters in order): every conv and linear weight ~ N(0, 2 /
    fan_in), biases 0, norm weights 1."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(2.0 / p[0].numel()))
        else:
            p.fill_(0.0 if name.endswith(".bias") else 1.0)
    return model
