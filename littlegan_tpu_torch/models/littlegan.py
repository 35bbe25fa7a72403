"""The LittleGAN model family as ``nn.Module``s that share their sub-modules.

The port of littlegan_tpu/models/littlegan.py. The reference wires five
Keras models with aliased parts; here one :class:`LittleGAN` holds one
instance of each part and exposes the three networks, so weight sharing is
by construction:

    generator     = GHead -> Decoder (no skips) -> OutConv
    discriminator = Encoder -> DHead
    adjuster      = Encoder -> AdjHead -> Decoder (reversed encoder maps as
                    skip-adds) -> OutConv

Parameters keep the JAX package's names and layouts: ``encoder.block1.conv.
kernel`` is the checkpoint key ``encoder/block1/conv/kernel``, HWIO; decoder
and out_conv kernels are ``(kh, kw, out, in)``. ``compat/jax_params.py``
loads a JAX parameter set into a model, and ``ops/conv.py`` permutes to
PyTorch's layouts at each call.

All compute is NHWC in ``cfg.compute_dtype``; instance-norm stats are f32.
With ``cfg.use_pallas`` every encoder/decoder block epilogue runs the fused
norm + LeakyReLU CUDA kernel; with ``cfg.use_pallas_boundary`` encoder
block1 (s2d form) runs the boundary conv kernel with fused stats, then the
stats-in norm kernel. Both go through their autograd Functions
(``FusedNormLReLU``, ``BoundaryConvS2D``, ``NormLReLUFromStats``), whose
backwards are kernels too, so the gradient reaches every parameter. On CPU
tensors they take their plain versions. Dropout is the reference's inert
one: the JAX train step passes no dropout key either.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.ops import s2d
from littlegan_tpu_torch.ops.conv import conv2d, deconv2d, dense, leaky_relu
from littlegan_tpu_torch.ops.cuda import boundary_conv
from littlegan_tpu_torch.ops.cuda.norm_lrelu import FusedNormLReLU, NormLReLUFromStats
from littlegan_tpu_torch.ops.norm import instance_norm


def s2d_active(cfg: Config) -> bool:
    """Whether the space-to-depth boundary path applies: the kernel
    rearrangements are derived for 5x5 kernels and an even image size."""
    return cfg.use_s2d and cfg.kernel_size == 5 and cfg.image_dim % 2 == 0


def _dtype(cfg: Config) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class Affine(nn.Module):
    """``kernel`` and ``bias`` of a conv, transposed conv or dense layer."""

    def __init__(self, kernel_shape: Sequence[int], out: int):
        super().__init__()
        self.kernel = _param(*kernel_shape)
        self.bias = _param(out)


class Norm(nn.Module):
    """Scalar ``gamma`` / ``beta`` of an ``axis=None`` instance norm."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1))
        self.beta = nn.Parameter(torch.zeros(1))


class Block(nn.Module):
    def __init__(self, kernel_shape: Sequence[int], out: int):
        super().__init__()
        self.conv = Affine(kernel_shape, out)
        self.norm = Norm()


def _norm_lrelu(x: torch.Tensor, norm: Norm, cfg: Config) -> torch.Tensor:
    """InstanceNorm -> LeakyReLU block epilogue: the fused kernel when
    ``cfg.use_pallas``, plain ops otherwise."""
    if cfg.use_pallas and x.dim() == 4:
        return FusedNormLReLU.apply(x.contiguous(), norm.gamma, norm.beta, cfg.leaky_alpha)
    return leaky_relu(instance_norm(x, norm.gamma, norm.beta), cfg.leaky_alpha)


class Encoder(nn.Module):
    """4x [conv(s2) -> InstanceNorm -> LeakyReLU]; channels 3 -> cf[3] ->
    cf[2] -> cf[1] -> cf[0]. Returns all four feature maps."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        cf, k = cfg.conv_filter, cfg.kernel_size
        ch = [cfg.image_channel, cf[3], cf[2], cf[1], cf[0]]
        for i in range(1, 5):
            self.add_module(f"block{i}", Block((k, k, ch[i - 1], ch[i]), ch[i]))

    def forward(self, x: torch.Tensor, s2d_in: bool = False) -> List[torch.Tensor]:
        cfg = self.cfg
        x = x.to(_dtype(cfg))
        if s2d_active(cfg) and not s2d_in:
            x = s2d.space_to_depth(x)
        outputs = []
        for i in range(1, 5):
            blk = getattr(self, f"block{i}")
            if i == 1 and s2d_active(cfg):
                kern = s2d.s2d_conv1_kernel(blk.conv.kernel)
                if cfg.use_pallas_boundary and boundary_conv.supports(x.shape):
                    y, s1, s2 = boundary_conv.BoundaryConvS2D.apply(
                        x.contiguous(), kern.to(x.dtype), blk.conv.bias
                    )
                    x = NormLReLUFromStats.apply(y, s1, s2, blk.norm.gamma, blk.norm.beta, cfg.leaky_alpha)
                else:
                    x = _norm_lrelu(conv2d(x, kern, blk.conv.bias, stride=1), blk.norm, cfg)
            else:
                x = _norm_lrelu(conv2d(x, blk.conv.kernel, blk.conv.bias, stride=2), blk.norm, cfg)
            outputs.append(x)
        return outputs


class Decoder(nn.Module):
    """4x [skip-add? -> transposed conv(s2) -> InstanceNorm -> LeakyReLU];
    channels cf[0] -> cf[1] -> cf[2] -> cf[3] -> cf[4]. In s2d mode block4's
    output comes out in s2d form [N, H/2, W/2, 4*cf[4]]."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        cf, k = cfg.conv_filter, cfg.kernel_size
        for i in range(1, 5):
            self.add_module(f"block{i}", Block((k, k, cf[i], cf[i - 1]), cf[i]))

    def forward(self, x: torch.Tensor, skips: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        cfg = self.cfg
        x = x.to(_dtype(cfg))
        for i in range(1, 5):
            blk = getattr(self, f"block{i}")
            if skips[i - 1] is not None:
                x = x + skips[i - 1].to(x.dtype)
            if i == 4 and s2d_active(cfg):
                x = conv2d(
                    x, s2d.s2d_deconv_kernel(blk.conv.kernel), s2d.tile_bias(blk.conv.bias), stride=1
                )
            else:
                x = deconv2d(x, blk.conv.kernel, blk.conv.bias, stride=2)
            x = _norm_lrelu(x, blk.norm, cfg)
        return x


class GHead(nn.Module):
    """concat(noise, cond) -> dense -> LeakyReLU -> reshape -> InstanceNorm."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        feat = cfg.init_dim * cfg.init_dim * cfg.conv_filter[0]
        self.dense = Affine((cfg.noise_dim + cfg.cond_dim, feat), feat)
        self.norm = Norm()

    def forward(self, noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = torch.cat([noise, cond], dim=-1).to(_dtype(cfg))
        x = leaky_relu(dense(x, self.dense.kernel, self.dense.bias), cfg.leaky_alpha)
        x = x.reshape(-1, cfg.init_dim, cfg.init_dim, cfg.conv_filter[0])
        return instance_norm(x, self.norm.gamma, self.norm.beta)


class AdjHead(nn.Module):
    """cond -> dense -> LeakyReLU -> InstanceNorm -> reshape (the reference's
    order, which differs from GHead's)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        feat = cfg.init_dim * cfg.init_dim * cfg.conv_filter[0]
        self.dense = Affine((cfg.cond_dim, feat), feat)
        self.norm = Norm()

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        c = dense(cond.to(_dtype(cfg)), self.dense.kernel, self.dense.bias)
        c = instance_norm(leaky_relu(c, cfg.leaky_alpha), self.norm.gamma, self.norm.beta)
        return c.reshape(-1, cfg.init_dim, cfg.init_dim, cfg.conv_filter[0])


class OutConv(nn.Module):
    """G's stride-1 tanh output transposed conv, shared with the adjuster. In
    s2d mode input and output stay in block space. With ``cfg.cond_bias`` a
    per-sample cond-dependent channel bias is added before the tanh."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        k = cfg.kernel_size
        self.kernel = _param(k, k, cfg.image_channel, cfg.conv_filter[4])
        self.bias = _param(cfg.image_channel)
        if cfg.cond_bias:
            self.cond_kernel = _param(cfg.cond_dim, cfg.image_channel)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if s2d_active(cfg):
            y = conv2d(x, s2d.s2d_outconv_kernel(self.kernel), s2d.tile_bias(self.bias), stride=1)
        else:
            y = deconv2d(x, self.kernel, self.bias, stride=1)
        if cfg.cond_bias and cond is not None:
            b = dense(cond.to(y.dtype), self.cond_kernel)  # (N, C)
            if s2d_active(cfg):
                b = b.repeat(1, 4)  # channel order (pi, pj, c)
            y = y + b[:, None, None, :]
        # tanh in f32, the image carried in the compute dtype
        return torch.tanh(y.float()).to(_dtype(cfg))


class DHead(nn.Module):
    """flatten (NHWC order) -> two dense heads: real/fake and condition."""

    def __init__(self, cfg: Config):
        super().__init__()
        feat = cfg.init_dim * cfg.init_dim * cfg.conv_filter[0]
        self.pr = Affine((feat, 1), 1)
        self.cond = Affine((feat, cfg.cond_dim), cfg.cond_dim)

    def forward(self, fmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = fmap.reshape(fmap.shape[0], -1)
        pr = dense(flat, self.pr.kernel, self.pr.bias)
        cond = dense(flat, self.cond.kernel, self.cond.bias)
        return torch.sigmoid(pr.float()), torch.sigmoid(cond.float())


class LittleGAN(nn.Module):
    """All six parts, shared by the generator, discriminator and adjuster."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.g_head = GHead(cfg)
        self.out_conv = OutConv(cfg)
        self.d_head = DHead(cfg)
        self.adj_head = AdjHead(cfg)

    def _image_out(self, y: torch.Tensor, s2d_out: bool) -> torch.Tensor:
        return s2d.depth_to_space(y) if s2d_active(self.cfg) and not s2d_out else y

    def generator(self, noise: torch.Tensor, cond: torch.Tensor, s2d_out: bool = False) -> torch.Tensor:
        """Image in [-1, 1] in the compute dtype."""
        x = self.decoder(self.g_head(noise, cond), [None] * 4)
        return self._image_out(self.out_conv(x, cond), s2d_out)

    def discriminator(self, image: torch.Tensor, s2d_in: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pr, cond) sigmoid outputs in f32."""
        return self.d_head(self.encoder(image, s2d_in=s2d_in)[-1])

    def adjuster(
        self, image: torch.Tensor, cond: torch.Tensor, s2d_in: bool = False, s2d_out: bool = False
    ) -> torch.Tensor:
        fmaps = self.encoder(image, s2d_in=s2d_in)
        x = self.decoder(self.adj_head(cond), fmaps[::-1])
        return self._image_out(self.out_conv(x, cond), s2d_out)


def _glorot_(p: torch.Tensor, gen: torch.Generator) -> None:
    """Glorot-uniform with the JAX/Keras fans: fan_in from axis -2, fan_out
    from axis -1, both times the receptive field (the other axes)."""
    rf = math.prod(p.shape[:-2])
    limit = math.sqrt(6.0 / (p.shape[-2] * rf + p.shape[-1] * rf))
    with torch.no_grad():
        p.copy_(torch.rand(p.shape, generator=gen, dtype=torch.float32) * (2 * limit) - limit)


def init_params(cfg: Config, seed: int = 0) -> LittleGAN:
    """A fresh model on the CPU: glorot kernels from a seeded
    ``torch.Generator``, zero biases, gamma 1, beta 0, cond_kernel zeros.
    (Another generator than the JAX package's, so other numbers.)"""
    model = LittleGAN(cfg)
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".kernel") and not name.endswith("cond_kernel"):
            _glorot_(p, gen)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
