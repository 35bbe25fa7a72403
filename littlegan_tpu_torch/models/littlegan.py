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
On the kernels' route (:func:`_kernels`: everywhere but under a spatial
mesh, the gradient penalty or ``ops/cuda/_build.py``'s ``plain_versions``)
every encoder/decoder block epilogue runs the
fused norm + LeakyReLU kernel, and encoder block1 (s2d form) the boundary
conv kernel with fused stats, then the stats-in norm kernel, where its
``supports`` takes the shape (else the plain conv and the block epilogue
above, as the JAX model does where its predicate says False). Both go
through their autograd Functions (``FusedNormLReLU``, ``BoundaryConvS2D``,
``NormLReLUFromStats``), whose backwards are kernels too, so the gradient
reaches every parameter. The Functions launch the kernels on a CUDA tensor
and take their plain versions on a CPU tensor (``ops/cuda/_build.py``'s
``runs_kernel``); the JAX package's kernel flags do not reach the port.
Where a kernel closes a block and TF SAME's border is uneven (stride 2
over an even map), the kernels read and write through the border instead
of a pad, crop or copy: encoder blocks 1-3 write their map inside the next
conv's border (the padded map goes to that conv whole, the interior view
everywhere else) and decoder blocks read their map out of the transposed
conv's full output (``ops/conv.py``'s ``conv2d_padded``,
``deconv2d_full``); not with dropout masks. Dropout is the reference's inert
one unless a caller passes ``dropout_masks`` to the encoder (through
``discriminator`` or ``adjuster``): one keep-mask per encoder block, of
the block's output shape, applied as JAX ``encoder_apply`` does with a
``dropout_rng`` (``where(mask, x / keep, 0)``, ``keep = 1 -
cfg.dropout_rate``). No train step passes masks, as the JAX train step
passes no dropout key: torch cannot draw ``jax.random``'s masks, so a
caller that wants the JAX package's dropout hands its masks over.

Each network takes ``sp``, a spatial mesh's model axis
(``parallel/spatial.py``; None otherwise): its images are this rank's rows,
each map is held H-sharded when its height (``cfg``'s, global) tiles the
model axis and replicated otherwise, and the ops run in their sharded forms
there, off the kernels' route (the act-sharding policy of JAX
``models/littlegan.py:204-223,280-309``). Without ``sp`` nothing changes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.ops import s2d
from littlegan_tpu_torch.ops.conv import (
    conv2d, conv2d_padded, deconv2d, deconv2d_full, dense, leaky_relu, same_border, same_crop,
)
from littlegan_tpu_torch.ops.cuda import _build, boundary_conv
from littlegan_tpu_torch.ops.cuda.norm_lrelu import FusedNormLReLU, NormLReLUFromStats
from littlegan_tpu_torch.ops.norm import instance_norm
from littlegan_tpu_torch.parallel import spatial


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


def _conv(x, kernel, bias, stride: int, sp, height: int) -> torch.Tensor:
    return conv2d(x, kernel, bias, stride=stride) if sp is None else spatial.conv(x, kernel, bias, stride, sp, height)


_EPS = 1e-3  # the instance norm's epsilon (ops/norm.py's default)


def _kernels(cfg: Config, sp) -> bool:
    """Whether the blocks take the kernels' route (``FusedNormLReLU``,
    ``NormLReLUFromStats``, ``BoundaryConvS2D``): not under a spatial mesh
    ``sp`` (the kernels take whole-sample moments), nor with ``cfg.use_gp``
    (the penalty differentiates D twice, and the kernels' backwards are
    first order only), nor inside ``_build.plain_versions()``."""
    return sp is None and not cfg.use_gp and not _build.plain_only()


def _norm_lrelu(x: torch.Tensor, norm: Norm, cfg: Config, sp=None, height: int = 0, border=None, crop=None):
    """InstanceNorm -> LeakyReLU block epilogue: the fused kernel's Function
    on the kernels' route, plain ops otherwise; under a spatial mesh ``sp``
    the sharded norm of a map ``height`` rows high. On the kernels' route
    only: ``border``, the map written inside it and (padded, map) returned;
    ``crop``, x a transposed conv's full output and the norm of that window."""
    if sp is not None:
        return leaky_relu(spatial.instance_norm(x, norm.gamma, norm.beta, sp, height), cfg.leaky_alpha)
    if _kernels(cfg, sp) and x.dim() == 4:
        x = x if crop is not None else x.contiguous()
        return FusedNormLReLU.apply(x, norm.gamma, norm.beta, cfg.leaky_alpha, _EPS, border, crop)
    return leaky_relu(instance_norm(x, norm.gamma, norm.beta), cfg.leaky_alpha)


def _next_border(y: torch.Tensor, cfg: Config):
    """The uneven SAME border of the encoder's next stride-2 conv over y,
    for y's norm kernel to write y inside; None where it is even."""
    return same_border(y.shape[1], y.shape[2], cfg.kernel_size, 2)


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
        s2d.register_index(self, "conv1")

    def forward(self, x: torch.Tensor, s2d_in: bool = False, sp=None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """``dropout_masks``: None (the reference's inert dropout), or one
        bool keep-mask per block of the block's output shape for the whole
        map; under a spatial mesh ``sp`` a rank applies the H-slice of it
        that its H-sharded map holds."""
        cfg = self.cfg
        x = x.to(_dtype(cfg))
        height = cfg.image_dim  # the map's global height, which decides its sharding under sp
        if s2d_active(cfg):
            height //= 2
            if not s2d_in:
                x = s2d.space_to_depth(x)
        outputs = []
        kernels = _kernels(cfg, sp)
        padded = None  # the last map inside this block's SAME border, where a norm kernel wrote it so
        for i in range(1, 5):
            blk = getattr(self, f"block{i}")
            bordered = kernels and dropout_masks is None and i < 4  # a kernel writes the next border
            if i == 1 and s2d_active(cfg):
                kern = s2d.s2d_conv1_kernel(blk.conv.kernel, s2d.module_index(self, "conv1"))
                if kernels and boundary_conv.supports(x.shape, kern.shape[3], x.dtype):
                    y, s1, s2 = boundary_conv.BoundaryConvS2D.apply(
                        x.contiguous(), kern.to(x.dtype), blk.conv.bias
                    )
                    border = _next_border(y, cfg) if bordered else None
                    x = NormLReLUFromStats.apply(y, s1, s2, blk.norm.gamma, blk.norm.beta, cfg.leaky_alpha, _EPS,
                                                 border)
                else:
                    y = _conv(x, kern, blk.conv.bias, 1, sp, height)
                    border = _next_border(y, cfg) if bordered else None
                    x = _norm_lrelu(y, blk.norm, cfg, sp, height, border)
            else:
                if padded is None:
                    y = _conv(x, blk.conv.kernel, blk.conv.bias, 2, sp, height)
                else:
                    y = conv2d_padded(padded, blk.conv.kernel, blk.conv.bias, 2)
                height //= 2
                border = _next_border(y, cfg) if bordered else None
                x = _norm_lrelu(y, blk.norm, cfg, sp, height, border)
            padded, x = x if border is not None else (None, x)
            if dropout_masks is not None:
                mask = dropout_masks[i - 1].to(x.device)
                if sp is not None and sp.tiles(height):
                    mask = mask[:, sp.part(height)]
                keep = 1.0 - cfg.dropout_rate
                x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
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
        s2d.register_index(self, "deconv")

    def forward(self, x: torch.Tensor, skips: Sequence[Optional[torch.Tensor]], sp=None) -> torch.Tensor:
        cfg = self.cfg
        x = x.to(_dtype(cfg))
        height = cfg.init_dim
        for i in range(1, 5):
            blk = getattr(self, f"block{i}")
            if skips[i - 1] is not None:
                x = x + skips[i - 1].to(x.dtype)
            crop = None  # the window of the full output its norm kernel takes, where SAME's crop is uneven
            if i == 4 and s2d_active(cfg):
                x = _conv(
                    x, s2d.s2d_deconv_kernel(blk.conv.kernel, s2d.module_index(self, "deconv")),
                    s2d.tile_bias(blk.conv.bias), 1, sp, height,
                )
            elif sp is None:
                if _kernels(cfg, sp):
                    crop = same_crop(x.shape[1], x.shape[2], cfg.kernel_size, 2)
                if crop is None:
                    x = deconv2d(x, blk.conv.kernel, blk.conv.bias, stride=2)
                else:
                    x = deconv2d_full(x, blk.conv.kernel, blk.conv.bias, stride=2)
                height *= 2
            else:
                x = spatial.deconv(x, blk.conv.kernel, blk.conv.bias, 2, sp, height)
                height *= 2
            x = _norm_lrelu(x, blk.norm, cfg, sp, height, crop=crop)
        return x


class GHead(nn.Module):
    """concat(noise, cond) -> dense -> LeakyReLU -> reshape -> InstanceNorm."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        feat = cfg.init_dim * cfg.init_dim * cfg.conv_filter[0]
        self.dense = Affine((cfg.noise_dim + cfg.cond_dim, feat), feat)
        self.norm = Norm()

    def forward(self, noise: torch.Tensor, cond: torch.Tensor, sp=None) -> torch.Tensor:
        cfg = self.cfg
        x = torch.cat([noise, cond], dim=-1).to(_dtype(cfg))
        if sp is None:
            x = leaky_relu(dense(x, self.dense.kernel, self.dense.bias), cfg.leaky_alpha)
            x = x.reshape(-1, cfg.init_dim, cfg.init_dim, cfg.conv_filter[0])
            return instance_norm(x, self.norm.gamma, self.norm.beta)
        # this rank's columns are its rows of the row-major reshape
        x = leaky_relu(spatial.head_dense(x, self.dense.kernel, self.dense.bias, sp, cfg.init_dim), cfg.leaky_alpha)
        x = x.reshape(x.shape[0], -1, cfg.init_dim, cfg.conv_filter[0])
        return spatial.instance_norm(x, self.norm.gamma, self.norm.beta, sp, cfg.init_dim)


class AdjHead(nn.Module):
    """cond -> dense -> LeakyReLU -> InstanceNorm -> reshape (the reference's
    order, which differs from GHead's)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        feat = cfg.init_dim * cfg.init_dim * cfg.conv_filter[0]
        self.dense = Affine((cfg.cond_dim, feat), feat)
        self.norm = Norm()

    def forward(self, cond: torch.Tensor, sp=None) -> torch.Tensor:
        cfg = self.cfg
        if sp is None:
            c = dense(cond.to(_dtype(cfg)), self.dense.kernel, self.dense.bias)
            c = instance_norm(leaky_relu(c, cfg.leaky_alpha), self.norm.gamma, self.norm.beta)
            return c.reshape(-1, cfg.init_dim, cfg.init_dim, cfg.conv_filter[0])
        c = spatial.head_dense(cond.to(_dtype(cfg)), self.dense.kernel, self.dense.bias, sp, cfg.init_dim)
        c = spatial.instance_norm(leaky_relu(c, cfg.leaky_alpha), self.norm.gamma, self.norm.beta, sp, cfg.init_dim)
        return c.reshape(c.shape[0], -1, cfg.init_dim, cfg.conv_filter[0])


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
        s2d.register_index(self, "outconv")

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None, sp=None) -> torch.Tensor:
        cfg = self.cfg
        if s2d_active(cfg):
            kern = s2d.s2d_outconv_kernel(self.kernel, s2d.module_index(self, "outconv"))
            y = _conv(x, kern, s2d.tile_bias(self.bias), 1, sp, cfg.image_dim // 2)
        elif sp is None:
            y = deconv2d(x, self.kernel, self.bias, stride=1)
        else:
            y = spatial.deconv(x, self.kernel, self.bias, 1, sp, cfg.image_dim)
        if cfg.cond_bias and cond is not None:
            # under sp: made on each rank and added to its own rows only, so
            # cond_kernel's gradient is this rank's share, as a sharded stage's
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
        self.cfg = cfg
        feat = cfg.init_dim * cfg.init_dim * cfg.conv_filter[0]
        self.pr = Affine((feat, 1), 1)
        self.cond = Affine((feat, cfg.cond_dim), cfg.cond_dim)

    def forward(self, fmap: torch.Tensor, sp=None) -> Tuple[torch.Tensor, torch.Tensor]:
        if sp is None:
            flat = fmap.reshape(fmap.shape[0], -1)
            pr = dense(flat, self.pr.kernel, self.pr.bias)
            cond = dense(flat, self.cond.kernel, self.cond.bias)
        else:
            pr, cond = spatial.d_head(fmap, self.pr, self.cond, sp, self.cfg.init_dim)
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

    def generator(self, noise: torch.Tensor, cond: torch.Tensor, s2d_out: bool = False, sp=None) -> torch.Tensor:
        """Image in [-1, 1] in the compute dtype."""
        x = self.decoder(self.g_head(noise, cond, sp=sp), [None] * 4, sp=sp)
        return self._image_out(self.out_conv(x, cond, sp=sp), s2d_out)

    def discriminator(self, image: torch.Tensor, s2d_in: bool = False, sp=None,
                      dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pr, cond) sigmoid outputs in f32; ``dropout_masks``: the
        encoder's (:meth:`Encoder.forward`)."""
        return self.d_head(self.encoder(image, s2d_in=s2d_in, sp=sp, dropout_masks=dropout_masks)[-1], sp=sp)

    def adjuster(
        self, image: torch.Tensor, cond: torch.Tensor, s2d_in: bool = False, s2d_out: bool = False, sp=None,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        fmaps = self.encoder(image, s2d_in=s2d_in, sp=sp, dropout_masks=dropout_masks)
        x = self.decoder(self.adj_head(cond, sp=sp), fmaps[::-1], sp=sp)
        return self._image_out(self.out_conv(x, cond, sp=sp), s2d_out)


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
