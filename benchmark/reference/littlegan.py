"""Plain LittleGAN in float32 PyTorch: the yardstick every cell's outputs
are judged against.

Written from the reference implementation's description (IXarea/LittleGAN,
``sample.config.json``): NHWC tensors, TF SAME padding, 5x5 kernels, an
``axis=None`` instance norm (one mean and one standard deviation per
sample over all its values, scalar gamma and beta, eps added to the
standard deviation), LeakyReLU, a tanh image and two sigmoid heads. One
train update is the reference's ``eager_trainer.py``: the real batch
augmented, three losses on one graph, each parameter group differentiated
by its own loss, D's gradient clipped, three masked TF-v1 Adams under the
partition schedule and the adjuster's warm-up gate.

Parameters are a dict of JAX-style keys (``encoder/block1/conv/kernel``)
to float32 tensors in the reference's layouts: conv kernels HWIO,
transposed-conv kernels ``(kh, kw, out, in)``, dense kernels ``(in,
out)``. Nothing here imports the program under test: no kernel, no
space-to-depth, no CUDA graph.

``Precision("fp8")`` is the control, the precision below the
configuration's bfloat16: every tensor the program holds in its compute
dtype (the images a network takes, each convolution's, dense layer's,
block's and head's output) is held in float8 e4m3 with a per-tensor scale,
each convolution and dense layer takes its operands so rounded, and the
gradient flowing back through each rounding is rounded to e5m2; statistics,
losses and the optimizer stay float32, as the program keeps them. ``half_batch=True`` is a planted fault: each loss is taken over
the first half of every batch only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def soft(x):
    """The reference's label smoothing."""
    return 0.96 * x + 0.02


# ----------------------------------------------------------------- precision --


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to an 8-bit float with one scale for the whole tensor
    (its largest magnitude maps to the format's largest value)."""
    amax = x.detach().abs().max().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


@dataclass(frozen=True)
class Precision:
    """``float32``: the reference. ``fp8``: the control."""

    name: str = "float32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the compute dtype holds it."""
        return _Fp8.apply(x) if self.name == "fp8" else x


F32 = Precision()


def no_tf32():
    """Float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------- ops --


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, kernel, bias, stride: int, pr: Precision = F32):
    """SAME conv, x NHWC, kernel HWIO."""
    ph = same_pads(x.shape[1], kernel.shape[0], stride)
    pw = same_pads(x.shape[2], kernel.shape[1], stride)
    xt = F.pad(pr.q(x).permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xt, pr.q(kernel).permute(3, 2, 0, 1), bias, stride=stride)
    return pr.q(y.permute(0, 2, 3, 1))


def deconv(x, kernel, bias, stride: int, pr: Precision = F32):
    """SAME transposed conv with TF semantics (the transpose of ``conv`` on
    an input ``stride`` times larger); kernel ``(kh, kw, out, in)``."""
    oh, ow = x.shape[1] * stride, x.shape[2] * stride
    ph = same_pads(oh, kernel.shape[0], stride)
    pw = same_pads(ow, kernel.shape[1], stride)
    y = F.conv_transpose2d(pr.q(x).permute(0, 3, 1, 2), pr.q(kernel).permute(3, 2, 0, 1), bias, stride=stride)
    return pr.q(y[:, :, ph[0]:ph[0] + oh, pw[0]:pw[0] + ow].permute(0, 2, 3, 1))


def dense(x, kernel, bias, pr: Precision = F32):
    return pr.q(F.linear(pr.q(x), pr.q(kernel).t(), bias))


def lrelu(x, alpha: float):
    return F.leaky_relu(x, alpha)


def inorm(x, gamma, beta, eps: float = 1e-3):
    """Instance norm over every non-batch axis (the reference's ``axis=None``)."""
    red = tuple(range(1, x.ndim))
    mean = x.mean(red, keepdim=True)
    std = (x - mean).square().mean(red, keepdim=True).sqrt()
    return (x - mean) / (std + eps) * gamma + beta


# --------------------------------------------------------------------- model --


@dataclass
class Model:
    """The sizes the networks need, read from a configuration file."""

    image_dim: int
    init_dim: int
    noise_dim: int
    cond_dim: int
    conv_filter: List[int]
    kernel_size: int = 5
    image_channel: int = 3
    leaky_alpha: float = 0.3
    pr: Precision = field(default=F32)

    @classmethod
    def from_config(cls, cfg: dict, pr: Precision = F32) -> "Model":
        return cls(cfg["image_dim"], cfg["init_dim"], cfg["noise_dim"], len(cfg["attr"]), list(cfg["conv_filter"]),
                   cfg.get("kernel_size", 5), cfg.get("image_channel", 3), cfg.get("leaky_alpha", 0.3), pr)

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's key and shape."""
        cf, k, c = self.conv_filter, self.kernel_size, self.image_channel
        feat = self.init_dim * self.init_dim * cf[0]
        out: Dict[str, Tuple[int, ...]] = {}
        enc = [c, cf[3], cf[2], cf[1], cf[0]]
        for i in range(1, 5):
            out[f"encoder/block{i}/conv/kernel"] = (k, k, enc[i - 1], enc[i])
            out[f"encoder/block{i}/conv/bias"] = (enc[i],)
            out[f"encoder/block{i}/norm/gamma"] = (1,)
            out[f"encoder/block{i}/norm/beta"] = (1,)
        for i in range(1, 5):
            out[f"decoder/block{i}/conv/kernel"] = (k, k, cf[i], cf[i - 1])
            out[f"decoder/block{i}/conv/bias"] = (cf[i],)
            out[f"decoder/block{i}/norm/gamma"] = (1,)
            out[f"decoder/block{i}/norm/beta"] = (1,)
        out["g_head/dense/kernel"] = (self.noise_dim + self.cond_dim, feat)
        out["g_head/dense/bias"] = (feat,)
        out["g_head/norm/gamma"] = (1,)
        out["g_head/norm/beta"] = (1,)
        out["out_conv/kernel"] = (k, k, c, cf[4])
        out["out_conv/bias"] = (c,)
        out["d_head/pr/kernel"] = (feat, 1)
        out["d_head/pr/bias"] = (1,)
        out["d_head/cond/kernel"] = (feat, self.cond_dim)
        out["d_head/cond/bias"] = (self.cond_dim,)
        out["adj_head/dense/kernel"] = (self.cond_dim, feat)
        out["adj_head/dense/bias"] = (feat,)
        out["adj_head/norm/gamma"] = (1,)
        out["adj_head/norm/beta"] = (1,)
        return out

    # the three networks, on float32 NHWC images in [-1, 1]
    def encoder(self, p: Params, x) -> List[torch.Tensor]:
        maps = []
        for i in range(1, 5):
            b = f"encoder/block{i}/"
            x = conv(x, p[b + "conv/kernel"], p[b + "conv/bias"], 2, self.pr)
            x = self.pr.q(lrelu(inorm(x, p[b + "norm/gamma"], p[b + "norm/beta"]), self.leaky_alpha))
            maps.append(x)
        return maps

    def decoder(self, p: Params, x, skips: Sequence[Optional[torch.Tensor]]):
        for i in range(1, 5):
            b = f"decoder/block{i}/"
            if skips[i - 1] is not None:
                x = self.pr.q(x + skips[i - 1])
            x = deconv(x, p[b + "conv/kernel"], p[b + "conv/bias"], 2, self.pr)
            x = self.pr.q(lrelu(inorm(x, p[b + "norm/gamma"], p[b + "norm/beta"]), self.leaky_alpha))
        return self.pr.q(torch.tanh(deconv(x, p["out_conv/kernel"], p["out_conv/bias"], 1, self.pr)))

    def _grid(self, x):
        return x.reshape(-1, self.init_dim, self.init_dim, self.conv_filter[0])

    def generator(self, p: Params, noise, cond):
        x = lrelu(dense(torch.cat([noise, cond], -1), p["g_head/dense/kernel"], p["g_head/dense/bias"], self.pr),
                  self.leaky_alpha)
        x = self.pr.q(inorm(self._grid(self.pr.q(x)), p["g_head/norm/gamma"], p["g_head/norm/beta"]))
        return self.decoder(p, x, [None] * 4)

    def discriminator(self, p: Params, image):
        flat = self.encoder(p, self.pr.q(image))[-1].reshape(image.shape[0], -1)
        pr = torch.sigmoid(dense(flat, p["d_head/pr/kernel"], p["d_head/pr/bias"], self.pr))
        cond = torch.sigmoid(dense(flat, p["d_head/cond/kernel"], p["d_head/cond/bias"], self.pr))
        return pr, cond

    def adjuster(self, p: Params, image, cond01):
        maps = self.encoder(p, self.pr.q(image))
        c = self.pr.q(lrelu(dense(cond01, p["adj_head/dense/kernel"], p["adj_head/dense/bias"], self.pr),
                            self.leaky_alpha))
        c = self._grid(self.pr.q(inorm(c, p["adj_head/norm/gamma"], p["adj_head/norm/beta"])))
        return self.decoder(p, c, maps[::-1])


def glorot_limits(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, float]:
    """The Glorot-uniform limit of every kernel (fan in from axis -2, fan
    out from axis -1, both times the receptive field)."""
    out = {}
    for k, s in shapes.items():
        if k.endswith("kernel"):
            rf = math.prod(s[:-2])
            out[k] = math.sqrt(6.0 / (s[-2] * rf + s[-1] * rf))
    return out


def init_params(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device) -> Params:
    """Glorot-uniform kernels in ONE draw from ``gen``, zero biases, gamma 1,
    beta 0, all float32 on ``device``."""
    limits = glorot_limits(shapes)
    sizes = [math.prod(shapes[k]) for k in limits]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(torch.tensor(list(limits.values()), device=device),
                                    torch.tensor(sizes, device=device))
    flat = (u * 2.0 - 1.0) * scale
    out, off = {}, 0
    for k, n in zip(limits, sizes):
        out[k] = flat[off:off + n].view(shapes[k])
        off += n
    for k, s in shapes.items():
        if k not in out:
            fill = 1.0 if k.endswith("gamma") else 0.0
            out[k] = torch.full(s, fill, device=device)
    return {k: out[k] for k in shapes}


# -------------------------------------------------------------------- losses --


def bce(t, p):
    """Keras' probability-space binary cross-entropy, mean over the last axis."""
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return (-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))).mean(-1).mean()


def disc_loss(cond, real_c, real_pr, fake_pr):
    return (2.0 * bce(cond, real_c) + bce(torch.full_like(real_pr, soft(1.0)), real_pr)
            + bce(torch.full_like(fake_pr, soft(0.0)), fake_pr))


def gen_loss(cond, c, pr, target, image, l1: float):
    return bce(torch.full_like(pr, soft(1.0)), pr) + bce(cond, c) + l1 * (target - image).abs().mean()


# ---------------------------------------------------------------- augmenting --


def adjust_hue(x, delta):
    """TF's adjust_hue kernel on the trailing RGB axis."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    m = torch.minimum(torch.minimum(r, g), b)
    c = v - m
    norm = 1.0 / (6.0 * torch.where(c != 0, c, torch.ones_like(c)))
    h = torch.where(v == r, norm * (g - b), torch.where(v == g, norm * (b - r) + 2.0 / 6.0, norm * (r - g) + 4.0 / 6.0))
    h = torch.where(c == 0, torch.zeros_like(h), h)
    h = torch.where(h < 0, h + 1.0, h)
    h = torch.remainder(h + delta, 1.0)
    dh = h * 6.0
    x1 = c * (1.0 - (torch.remainder(dh, 2.0) - 1.0).abs())
    i = torch.floor(dh).to(torch.int32) % 6
    z = torch.zeros_like(c)
    sel = lambda ch: torch.stack(ch, -1).gather(-1, i.long().unsqueeze(-1)).squeeze(-1)  # noqa: E731
    rr = sel([c, x1, z, z, x1, c])
    gg = sel([x1, c, c, x1, z, z])
    bb = sel([z, z, x1, c, c, x1])
    return torch.stack([rr + m, gg + m, bb + m], -1)


def augment(x, flip, delta_b, factor, delta_h, noise):
    """Flip, brightness, contrast, hue and additive noise, the reference's chain."""
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    x = x + delta_b
    mean = x.mean((1, 2), keepdim=True)
    x = (x - mean) * factor + mean
    return adjust_hue(x, delta_h) + 0.1 * (0.2 * noise)


# ------------------------------------------------------------------ training --


_G_GROUPS = [["g_head/"], ["decoder/block1/"], ["decoder/block2/", "decoder/block3/", "decoder/block4/", "out_conv/"]]
_D_GROUPS = [["encoder/block1/", "encoder/block2/", "encoder/block3/"], ["encoder/block4/"], ["d_head/"]]
_A_GROUPS = [["adj_head/"]]
OPTS = (("G", ("g_head/", "decoder/", "out_conv/"), _G_GROUPS, 0.5, 0.9),
        ("D", ("encoder/", "d_head/"), _D_GROUPS, 0.5, 0.9),
        ("A", ("adj_head/",), _A_GROUPS, 0.9, 0.999))


@dataclass
class Hyper:
    lr: float = 5e-5
    l1_lambda: float = 0.02
    clip_range: float = 0.5
    partition_interval: int = 4
    train_adj: bool = True

    @classmethod
    def from_config(cls, cfg: dict) -> "Hyper":
        return cls(cfg.get("lr", 5e-5), cfg.get("l1_lambda", 0.02), cfg.get("clip_range", 0.5),
                   cfg.get("partition_interval", 4), cfg.get("train_adj", True))


def group_of(key: str) -> Tuple[str, float, float]:
    for name, prefixes, _, b1, b2 in OPTS:
        if key.startswith(prefixes):
            return name, b1, b2
    raise KeyError(key)


def active(key: str, batch_no: int, hp: Hyper) -> bool:
    """Whether leaf ``key`` trains at ``batch_no``: the partition schedule
    (on every ``interval + 1``-th batch one group per model) and the
    adjuster's warm-up gate (after batch 10)."""
    for name, prefixes, groups, _, _ in OPTS:
        if not key.startswith(prefixes):
            continue
        if name == "A" and not (hp.train_adj and batch_no > 10):
            return False
        period = hp.partition_interval + 1
        if batch_no % period != 0:
            return True
        grp = groups[(batch_no // period) % len(groups)]
        return any(key.startswith(p) for p in grp)
    raise KeyError(key)


class Adam:
    """Three masked TF-v1 Adams over one parameter dict: per-leaf apply
    counts, ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, eps outside the
    square root; a masked-off leaf keeps value, moments and count."""

    def __init__(self, params: Params):
        self.count = {k: 0 for k in params}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, batch_no: int, hp: Hyper) -> None:
        f32 = np.float32
        for k, g in grads.items():
            if not active(k, batch_no, hp):
                continue
            _, b1, b2 = group_of(k)
            self.count[k] += 1
            t = f32(self.count[k])
            lr_t = float(f32(hp.lr) * np.sqrt(f32(1.0) - f32(b2) ** t) / (f32(1.0) - f32(b1) ** t))
            self.m[k].mul_(b1).add_(g * (1.0 - b1))
            self.v[k].mul_(b2).add_(g * g * (1.0 - b2))
            params[k].sub_(lr_t * self.m[k] / (self.v[k].sqrt() + 1e-8))


def losses(model: Model, p: Params, img1_u8, cond1, img2_u8, cond2, draws: dict, hp: Hyper,
           half_batch: bool = False) -> Dict[str, torch.Tensor]:
    """The three losses of one update on one autograd graph. ``draws``:
    noise, flip, delta_b, factor, delta_h, aug_noise of this update."""
    n = img1_u8.shape[0] // 2 if half_batch else img1_u8.shape[0]
    img1 = img1_u8[:n].float() / 127.5 - 1.0
    img2 = img2_u8[:n].float() / 127.5 - 1.0
    cond1, cond2 = cond1[:n], cond2[:n]
    real = augment(img1, draws["flip"][:n], draws["delta_b"], draws["factor"], draws["delta_h"],
                   draws["aug_noise"][:n])
    fake = model.generator(p, draws["noise"][:n], cond2)
    real_pr, real_c = model.discriminator(p, real)
    fake_pr, fake_c = model.discriminator(p, fake)
    out = {"disc": disc_loss(cond1, real_c, real_pr, fake_pr),
           "gen": gen_loss(cond2, fake_c, fake_pr, img2, fake, hp.l1_lambda)}
    if hp.train_adj:
        tgt_cond = torch.cat([cond2, cond1])
        adj = model.adjuster(p, torch.cat([img1, fake.detach()]), (tgt_cond + 1.0) * 0.5)
        adj_pr, adj_c = model.discriminator(p, adj)
        out["adj"] = gen_loss(tgt_cond, adj_c, adj_pr, torch.cat([img2, img1]), adj, hp.l1_lambda)
    else:
        out["adj"] = torch.zeros((), device=fake.device)
    return out


def grads_of(p: Params, loss: Dict[str, torch.Tensor], hp: Hyper) -> Params:
    """Each group's gradient of its own loss (D <- disc, G <- gen, A <-
    adj), D's clipped to +-clip_range: the gradients as the Adams take them."""
    out: Params = {}
    routes = [("disc", "D"), ("gen", "G")] + ([("adj", "A")] if hp.train_adj else [])
    for i, (name, opt) in enumerate(routes):
        keys = [k for k in p if group_of(k)[0] == opt]
        gs = torch.autograd.grad(loss[name], [p[k] for k in keys], retain_graph=i < len(routes) - 1)
        for k, g in zip(keys, gs):
            out[k] = g.clamp(-hp.clip_range, hp.clip_range) if opt == "D" else g
    return out


def train_update(model: Model, p: Params, adam: Adam, batch: tuple, draws: dict, batch_no: int, hp: Hyper,
                 half_batch: bool = False) -> Tuple[Dict[str, float], Params]:
    """One update in place on ``p`` and ``adam``: (the three losses, the
    gradients the Adams took). ``batch``: (img1 uint8, cond1, img2 uint8, cond2)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = losses(model, leaves, *batch, draws, hp, half_batch)
    grads = grads_of(leaves, loss, hp)
    adam.update(p, grads, batch_no, hp)
    return {k: float(v.detach()) for k, v in loss.items()}, grads
