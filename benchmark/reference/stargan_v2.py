"""Plain StarGAN v2 in float32 PyTorch: the yardstick of the
``stargan-v2-afhq-256`` cell, and what the port's CPU tests compare with.

Written from the published code (github.com/clovaai/stargan-v2,
arXiv:1912.01865): ``core/model.py`` with ``w_hpf = 0`` (no face-alignment
network, no high-pass skips) and ``core/solver.py``'s training loop body.

- ``ResBlk``: shortcut (1x1 conv without bias where the widths differ,
  then a 2x2 average pool when downsampling) plus residual (IN, LeakyReLU
  0.2, 3x3 conv, pool, IN, LeakyReLU, 3x3 conv), over sqrt(2); the IN
  (eps 1e-5 on the biased variance, affine) only in the generator's
  encoder.
- ``AdainResBlk``: residual AdaIN ``(1 + gamma) * IN(x) + beta`` with
  ``(gamma, beta)`` from ``Linear(style_dim, 2C)``, LeakyReLU, nearest x2
  upsampling, 3x3 conv, AdaIN, LeakyReLU, 3x3 conv; plus the shortcut
  (upsample, then the 1x1 conv where the widths differ), over sqrt(2).
- Generator: 3x3 ``from_rgb``, ``log2(size) - 4`` downsampling blocks and
  two bottleneck blocks, the mirrored AdaIN blocks, then ``to_rgb`` (affine
  IN, LeakyReLU, 1x1 conv). Mapping network: four shared 512-wide linears
  with ReLU, then per domain three more and a ``style_dim`` output. Style
  encoder and discriminator: a 3x3 conv, ``log2(size) - 2`` downsampling
  blocks without norm, LeakyReLU, a 4x4 valid conv, LeakyReLU, then per
  domain a linear (style encoder) or a 1x1 conv to one logit per domain
  (discriminator). Every per-domain head is computed and the one of each
  sample's label gathered.
- One iteration: D latent-guided and D reference-guided (BCE on real and
  fake logits plus lambda_reg times R1, ``0.5 * mean_b sum (dD/dx_real)^2``
  taken with ``create_graph``; the fake made without gradient), each
  followed by D's Adam step; G latent-guided (adv + lambda_sty * |E(fake) -
  s| - lambda_ds * |fake - fake2| + lambda_cyc * |G(fake, E(real)) - real|)
  stepping G, F and E; G reference-guided stepping G only; the EMA of G, F
  and E (``lerp(param, ema, beta)``). lambda_ds of iteration i is
  ``lambda_ds * (1 - i / ds_iter)``, not below 0. Adam is
  ``torch.optim.Adam`` itself (L2 ``weight_decay`` added to the gradient,
  eps added to the bias-corrected root), lr ``f_lr`` for F.

Parameters are a dict of the published ``state_dict`` names, each under its
network (``generator.encode.0.conv1.weight``), float32 in PyTorch's
layouts; :func:`init_params` draws ``he_init`` (Kaiming normal, fan in, on
every conv and linear weight; biases 0, norm weights 1) from a seed. The
images of an iteration are crops of a uint8 NHWC store, resized back with
bilinear sampling (:func:`crop_resize`). Nothing here imports the program
under test.

Departures from the published code:

- the random-resized crop cuts the stored 256x256 image (the published
  code cuts the 512x512 file, then resizes with torchvision), at the
  boxes and flips the caller draws;
- the EMA starts as a copy of the he_init weights (the published EMA
  networks are copies taken before ``he_init``, with PyTorch's default
  init);
- lambda_ds is computed per iteration, not decremented in place.

``Precision("fp8")`` is the control, as in ``littlegan.py``: every image,
convolution, linear and block output held in float8 e4m3 with a
per-tensor scale, gradients through each rounding in e5m2; norms' and
losses' arithmetic and the optimizer stay float32. ``fault`` plants one of
five faults in the reference's place: ``no_r1`` (R1 left out; its term
reads 0), ``ref_steps_fe`` (the reference-guided G phase also steps F and
E), ``half_batch`` (every loss over the first half of the batch), and two
in the phases after the first Adam step: ``d_ref_stale`` (the
reference-guided D phase's fake made from the latent-guided style, a
stale input) and ``g_ref_ds_sign`` (the reference-guided G loss adds the
diversity term where it subtracts it; at the published size its turn of
G's step signs is smaller than bf16's own, so the cell's check does not
see it, PERF.md §6).
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.littlegan import F32, Precision, no_tf32  # noqa: F401 (no_tf32: the driver's)

Params = Dict[str, torch.Tensor]
NETS = ("generator", "mapping_network", "style_encoder", "discriminator")
# the 14 loss terms of one iteration, in the order the phases take them
LOSSES = ("d_latent.real", "d_latent.fake", "d_latent.reg", "d_ref.real", "d_ref.fake", "d_ref.reg",
          "g_latent.adv", "g_latent.sty", "g_latent.ds", "g_latent.cyc",
          "g_ref.adv", "g_ref.sty", "g_ref.ds", "g_ref.cyc")
FAULTS = ("no_r1", "ref_steps_fe", "half_batch", "d_ref_stale", "g_ref_ds_sign")


# ----------------------------------------------------------------------- ops --


def conv(x, w, b, pad: int, pr: Precision):
    return pr.q(F.conv2d(pr.q(x), pr.q(w), b, padding=pad))


def linear(x, w, b, pr: Precision):
    return pr.q(F.linear(pr.q(x), pr.q(w), b))


def lrelu(x, alpha: float):
    return F.leaky_relu(x, alpha)


def inorm(x, w=None, b=None, eps: float = 1e-5):
    """Instance norm over H and W per (sample, channel), the biased variance."""
    mean = x.mean((2, 3), keepdim=True)
    var = (x - mean).square().mean((2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if w is not None:
        y = y * w[None, :, None, None] + b[None, :, None, None]
    return y


def pick(out, y):
    """Each sample's row of a (B, domains, ...) output, by its label."""
    return out[torch.arange(out.shape[0], device=out.device), y]


def crop_resize(images_u8, boxes, flips):
    """(n, C, H, W) float32 in [-1, 1] of n (H, W, C) uint8 images: each
    box ``(top, left, height, width)`` in pixels cut out and resized back
    to (H, W) with bilinear sampling at pixel centres, then mirrored where
    ``flips``."""
    x = images_u8.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    n, _, h, w = x.shape
    top, left, bh, bw = boxes.float().unbind(1)
    sx, sy = bw / w, bh / h
    theta = torch.zeros((n, 2, 3), device=x.device)
    theta[:, 0, 0] = torch.where(flips, -sx, sx)
    theta[:, 0, 2] = (2.0 * left + bw) / w - 1.0
    theta[:, 1, 1] = sy
    theta[:, 1, 2] = (2.0 * top + bh) / h - 1.0
    grid = F.affine_grid(theta, list(x.shape), align_corners=False)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=False)


# --------------------------------------------------------------------- model --


@dataclass
class Model:
    """The sizes the four networks need, read from a configuration file."""

    image_dim: int = 256
    num_domains: int = 3
    latent_dim: int = 16
    style_dim: int = 64
    mapping_dim: int = 512
    max_conv_dim: int = 512
    base_dim: int = 0  # 0: the published 2**14 // image_dim
    leaky_alpha: float = 0.2
    pr: Precision = field(default=F32)

    @classmethod
    def from_config(cls, cfg: dict, pr: Precision = F32) -> "Model":
        keys = ("image_dim", "num_domains", "latent_dim", "style_dim", "mapping_dim", "max_conv_dim", "base_dim",
                "leaky_alpha")
        return cls(**{k: cfg[k] for k in keys if k in cfg}, pr=pr)

    @property
    def dim(self) -> int:
        return self.base_dim or 2 ** 14 // self.image_dim

    def encoder_widths(self, repeat: int) -> List[Tuple[int, int]]:
        """(in, out) of ``repeat`` downsampling blocks from ``dim``."""
        out, d = [], self.dim
        for _ in range(repeat):
            out.append((d, min(2 * d, self.max_conv_dim)))
            d = out[-1][1]
        return out

    def g_blocks(self):
        """(encoder blocks, decoder blocks) of the generator: (in, out, resample)."""
        down = self.encoder_widths(int(math.log2(self.image_dim)) - 4)
        top = down[-1][1]
        enc = [(a, b, True) for a, b in down] + [(top, top, False)] * 2
        dec = [(top, top, False)] * 2 + [(b, a, True) for a, b in reversed(down)]
        return enc, dec

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's name and shape, in the published modules' order."""
        out: Dict[str, Tuple[int, ...]] = {}

        def conv_shape(key, cin, cout, k, bias=True):
            out[key + ".weight"] = (cout, cin, k, k)
            if bias:
                out[key + ".bias"] = (cout,)

        def lin_shape(key, cin, cout):
            out[key + ".weight"] = (cout, cin)
            out[key + ".bias"] = (cout,)

        def resblk(key, cin, cout, normalize):
            conv_shape(key + ".conv1", cin, cin, 3)
            conv_shape(key + ".conv2", cin, cout, 3)
            if normalize:
                for n in ("norm1", "norm2"):
                    out[f"{key}.{n}.weight"], out[f"{key}.{n}.bias"] = (cin,), (cin,)
            if cin != cout:
                conv_shape(key + ".conv1x1", cin, cout, 1, bias=False)

        d, s, m, nd = self.dim, self.style_dim, self.mapping_dim, self.num_domains
        enc, dec = self.g_blocks()
        conv_shape("generator.from_rgb", 3, d, 3)
        for i, (a, b, _) in enumerate(enc):
            resblk(f"generator.encode.{i}", a, b, True)
        for i, (a, b, _) in enumerate(dec):
            key = f"generator.decode.{i}"
            conv_shape(key + ".conv1", a, b, 3)
            conv_shape(key + ".conv2", b, b, 3)
            lin_shape(key + ".norm1.fc", s, 2 * a)
            lin_shape(key + ".norm2.fc", s, 2 * b)
            if a != b:
                conv_shape(key + ".conv1x1", a, b, 1, bias=False)
        out["generator.to_rgb.0.weight"], out["generator.to_rgb.0.bias"] = (d,), (d,)
        conv_shape("generator.to_rgb.2", d, 3, 1)
        lin_shape("mapping_network.shared.0", self.latent_dim, m)
        for j in (2, 4, 6):
            lin_shape(f"mapping_network.shared.{j}", m, m)
        for k in range(nd):
            for j in (0, 2, 4):
                lin_shape(f"mapping_network.unshared.{k}.{j}", m, m)
            lin_shape(f"mapping_network.unshared.{k}.6", m, s)
        blocks = self.encoder_widths(int(math.log2(self.image_dim)) - 2)
        top = blocks[-1][1]
        for net, seq in (("style_encoder", "shared"), ("discriminator", "main")):
            conv_shape(f"{net}.{seq}.0", 3, d, 3)
            for i, (a, b) in enumerate(blocks):
                resblk(f"{net}.{seq}.{i + 1}", a, b, False)
            conv_shape(f"{net}.{seq}.{len(blocks) + 2}", top, top, 4)
            if net == "style_encoder":
                for k in range(nd):
                    lin_shape(f"style_encoder.unshared.{k}", top, s)
        conv_shape(f"discriminator.main.{len(blocks) + 4}", top, nd, 1)
        return out

    # the networks, on float32 NCHW images in [-1, 1]
    def _resblk(self, p: Params, key: str, x, cin: int, cout: int, normalize: bool, down: bool):
        pr, a = self.pr, self.leaky_alpha
        sc = x
        if cin != cout:
            sc = conv(sc, p[key + ".conv1x1.weight"], None, 0, pr)
        if down:
            sc = F.avg_pool2d(sc, 2)
        r = x
        if normalize:
            r = pr.q(inorm(r, p[key + ".norm1.weight"], p[key + ".norm1.bias"]))
        r = conv(lrelu(r, a), p[key + ".conv1.weight"], p[key + ".conv1.bias"], 1, pr)
        if down:
            r = F.avg_pool2d(r, 2)
        if normalize:
            r = pr.q(inorm(r, p[key + ".norm2.weight"], p[key + ".norm2.bias"]))
        r = conv(lrelu(r, a), p[key + ".conv2.weight"], p[key + ".conv2.bias"], 1, pr)
        return pr.q((sc + r) / math.sqrt(2))

    def _adain(self, p: Params, key: str, x, s):
        h = linear(s, p[key + ".fc.weight"], p[key + ".fc.bias"], self.pr)
        gamma, beta = h.chunk(2, dim=1)
        return self.pr.q((1.0 + gamma[:, :, None, None]) * inorm(x) + beta[:, :, None, None])

    def _adain_resblk(self, p: Params, key: str, x, s, cin: int, cout: int, up: bool):
        pr, a = self.pr, self.leaky_alpha
        r = lrelu(self._adain(p, key + ".norm1", x, s), a)
        if up:
            r = F.interpolate(r, scale_factor=2, mode="nearest")
        r = conv(r, p[key + ".conv1.weight"], p[key + ".conv1.bias"], 1, pr)
        r = lrelu(self._adain(p, key + ".norm2", r, s), a)
        r = conv(r, p[key + ".conv2.weight"], p[key + ".conv2.bias"], 1, pr)
        sc = F.interpolate(x, scale_factor=2, mode="nearest") if up else x
        if cin != cout:
            sc = conv(sc, p[key + ".conv1x1.weight"], None, 0, pr)
        return pr.q((r + sc) / math.sqrt(2))

    def generator(self, p: Params, x, s):
        pr = self.pr
        x = conv(pr.q(x), p["generator.from_rgb.weight"], p["generator.from_rgb.bias"], 1, pr)
        enc, dec = self.g_blocks()
        for i, (a, b, down) in enumerate(enc):
            x = self._resblk(p, f"generator.encode.{i}", x, a, b, True, down)
        for i, (a, b, up) in enumerate(dec):
            x = self._adain_resblk(p, f"generator.decode.{i}", x, pr.q(s), a, b, up)
        x = pr.q(inorm(x, p["generator.to_rgb.0.weight"], p["generator.to_rgb.0.bias"]))
        return conv(lrelu(x, self.leaky_alpha), p["generator.to_rgb.2.weight"], p["generator.to_rgb.2.bias"], 0, pr)

    def mapping(self, p: Params, z, y):
        h = z
        for j in (0, 2, 4, 6):
            h = F.relu(linear(h, p[f"mapping_network.shared.{j}.weight"], p[f"mapping_network.shared.{j}.bias"],
                              self.pr))
        outs = []
        for k in range(self.num_domains):
            t = h
            for j in (0, 2, 4, 6):
                key = f"mapping_network.unshared.{k}.{j}"
                t = linear(t, p[key + ".weight"], p[key + ".bias"], self.pr)
                t = F.relu(t) if j < 6 else t
            outs.append(t)
        return pick(torch.stack(outs, 1), y)

    def _trunk(self, p: Params, net: str, seq: str, x):
        """The style encoder's and the discriminator's shared layers: (B, C) features."""
        pr, a = self.pr, self.leaky_alpha
        x = conv(pr.q(x), p[f"{net}.{seq}.0.weight"], p[f"{net}.{seq}.0.bias"], 1, pr)
        blocks = self.encoder_widths(int(math.log2(self.image_dim)) - 2)
        for i, (cin, cout) in enumerate(blocks):
            x = self._resblk(p, f"{net}.{seq}.{i + 1}", x, cin, cout, False, True)
        j = len(blocks) + 2
        return lrelu(conv(lrelu(x, a), p[f"{net}.{seq}.{j}.weight"], p[f"{net}.{seq}.{j}.bias"], 0, pr), a)

    def style_encoder(self, p: Params, x, y):
        h = self._trunk(p, "style_encoder", "shared", x).flatten(1)
        outs = [linear(h, p[f"style_encoder.unshared.{k}.weight"], p[f"style_encoder.unshared.{k}.bias"], self.pr)
                for k in range(self.num_domains)]
        return pick(torch.stack(outs, 1), y)

    def discriminator(self, p: Params, x, y):
        h = self._trunk(p, "discriminator", "main", x)
        j = len(self.encoder_widths(int(math.log2(self.image_dim)) - 2)) + 4
        out = conv(h, p[f"discriminator.main.{j}.weight"], p[f"discriminator.main.{j}.bias"], 0, self.pr)
        return pick(out.flatten(1), y)


def init_params(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device) -> Params:
    """``he_init`` in ONE normal draw from ``gen``: every conv and linear
    weight N(0, 2 / fan_in), biases 0, norm weights 1; float32 on ``device``."""
    weights = {k: s for k, s in shapes.items() if len(s) >= 2}
    sizes = [math.prod(s) for s in weights.values()]
    stds = [math.sqrt(2.0 / math.prod(s[1:])) for s in weights.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = flat * torch.repeat_interleave(torch.tensor(stds, device=device), torch.tensor(sizes, device=device))
    out, off = {}, 0
    for (k, s), n in zip(weights.items(), sizes):
        out[k] = flat[off:off + n].view(s)
        off += n
    for k, s in shapes.items():
        if k not in out:
            out[k] = torch.full(s, 0.0 if k.endswith(".bias") else 1.0, device=device)
    return {k: out[k] for k in shapes}


# ------------------------------------------------------------------ training --


@dataclass
class Hyper:
    lr: float = 1e-4
    f_lr: float = 1e-6
    beta_1: float = 0.0
    beta_2: float = 0.99
    weight_decay: float = 1e-4
    lambda_reg: float = 1.0
    lambda_sty: float = 1.0
    lambda_ds: float = 1.0
    lambda_cyc: float = 1.0
    ds_iter: int = 100000
    ema_decay: float = 0.999

    @classmethod
    def from_config(cls, cfg: dict) -> "Hyper":
        return cls(**{k: cfg[k] for k in cls.__dataclass_fields__ if k in cfg})

    def lambda_ds_at(self, it: int) -> float:
        return max(0.0, self.lambda_ds * (1.0 - it / self.ds_iter))


def adams(p: Params, hp: Hyper) -> Dict[str, torch.optim.Adam]:
    """``torch.optim.Adam`` of each network over ``p``'s tensors (leaves)."""
    return {net: torch.optim.Adam([v for k, v in p.items() if k.startswith(net + ".")],
                                  lr=hp.f_lr if net == "mapping_network" else hp.lr,
                                  betas=(hp.beta_1, hp.beta_2), weight_decay=hp.weight_decay)
            for net in NETS}


def leaves(p: Params) -> Params:
    """Copies of ``p`` that require gradients: the parameters an iteration updates in place."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


def new_ema(p: Params) -> Params:
    return {k: v.detach().clone() for k, v in p.items() if not k.startswith("discriminator.")}


def adv_loss(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def r1_reg(out, x):
    (g,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    return 0.5 * g.square().reshape(x.shape[0], -1).sum(1).mean(0)


def d_loss(model: Model, p: Params, x_real, y_org, y_trg, hp: Hyper, z=None, x_ref=None, r1: bool = True):
    """(loss, (real, fake, reg), the real images as the leaf R1 differentiates)."""
    x = x_real.detach().requires_grad_(True)
    out = model.discriminator(p, x, y_org)
    real = adv_loss(out, 1.0)
    reg = r1_reg(out, x) if r1 else torch.zeros((), device=x.device)
    with torch.no_grad():
        s = model.mapping(p, z, y_trg) if z is not None else model.style_encoder(p, x_ref, y_trg)
        x_fake = model.generator(p, x_real, s)
    fake = adv_loss(model.discriminator(p, x_fake, y_trg), 0.0)
    return real + fake + hp.lambda_reg * reg, (real, fake, reg), x


def g_loss(model: Model, p: Params, x_real, y_org, y_trg, lam_ds: float, hp: Hyper, z=None, z2=None, x_ref=None,
           x_ref2=None):
    """(loss, (adv, sty, ds, cyc)); latent-guided with ``z``, ``z2``, else
    reference-guided with ``x_ref``, ``x_ref2``."""
    style = (lambda v: model.mapping(p, v, y_trg)) if z is not None else (lambda v: model.style_encoder(p, v, y_trg))
    s_trg = style(z if z is not None else x_ref)
    x_fake = model.generator(p, x_real, s_trg)
    adv = adv_loss(model.discriminator(p, x_fake, y_trg), 1.0)
    sty = (model.style_encoder(p, x_fake, y_trg) - s_trg).abs().mean()
    x_fake2 = model.generator(p, x_real, style(z2 if z is not None else x_ref2)).detach()
    ds = (x_fake - x_fake2).abs().mean()
    x_rec = model.generator(p, x_fake, model.style_encoder(p, x_real, y_org))
    cyc = (x_rec - x_real).abs().mean()
    return adv + hp.lambda_sty * sty - lam_ds * ds + hp.lambda_cyc * cyc, (adv, sty, ds, cyc)


def _step(p: Params, opts, nets, loss, extra=(), grad_all: bool = False, grad_norms: Optional[dict] = None) -> None:
    """Gradients of ``loss`` into the Adams of ``nets``, which step. With
    ``grad_all`` the gradient is taken of every parameter and of ``extra``
    (the real images), as the published ``backward()`` takes it.
    ``grad_norms``: each stepped leaf's first gradient norm is kept there."""
    keys = [k for k in p if k.split(".", 1)[0] in nets]
    wrt = list(p) + list(extra) if grad_all else keys
    tensors = [p[k] if isinstance(k, str) else k for k in wrt]
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    by_key = {k: g for k, g in zip(wrt, grads) if isinstance(k, str)}
    if grad_norms is not None:
        for k in keys:
            grad_norms.setdefault(k, 0.0 if by_key[k] is None else float(torch.linalg.vector_norm(by_key[k].double())))
    if opts is None:  # counting operations: no update
        return
    with torch.no_grad():
        for k in keys:
            p[k].grad = by_key[k] if by_key[k] is not None else torch.zeros_like(p[k])
    for net in nets:
        opts[net].step()
    for k in keys:
        p[k].grad = None


def take(images_u8, labels, ids, boxes, flips, b: int):
    """(x_real, x_ref, x_ref2, y_org, y_trg) of one iteration's 3b ids into the store."""
    x = crop_resize(images_u8[ids], boxes, flips)
    y = labels[ids]
    return x[:b], x[b:2 * b], x[2 * b:], y[:b], y[b:2 * b]


def iteration(model: Model, p: Params, opts, ema: Optional[Params], batch: tuple, draws: dict, it: int, hp: Hyper,
              fault: Optional[str] = None, grad_all: bool = False, grad_norms: Optional[dict] = None) -> torch.Tensor:
    """One iteration in place on ``p``, ``opts`` and ``ema``: the (14,) loss
    terms (:data:`LOSSES`). ``batch``: (x_real, x_ref, x_ref2, y_org,
    y_trg); ``draws``: ``z``, ``z2``. ``opts`` None: no update (counting).
    ``grad_norms``: gets each leaf's first gradient norm."""
    x_real, x_ref, x_ref2, y_org, y_trg = batch
    z, z2 = draws["z"], draws["z2"]
    if fault == "half_batch":
        n = x_real.shape[0] // 2
        x_real, x_ref, x_ref2, y_org, y_trg, z, z2 = (t[:n] for t in (x_real, x_ref, x_ref2, y_org, y_trg, z, z2))
    r1 = fault != "no_r1"
    terms = []
    for guide in ("z", "ref"):
        by_z = guide == "z" or fault == "d_ref_stale"
        loss, t, x = d_loss(model, p, x_real, y_org, y_trg, hp, **({"z": z} if by_z else {"x_ref": x_ref}), r1=r1)
        _step(p, opts, ("discriminator",), loss, [x], grad_all, grad_norms)
        terms += t
    lam = hp.lambda_ds_at(it)
    x = x_real.detach().requires_grad_(True) if grad_all else x_real  # the published x_real requires grad here too
    loss, t = g_loss(model, p, x, y_org, y_trg, lam, hp, z=z, z2=z2)
    _step(p, opts, ("generator", "mapping_network", "style_encoder"), loss, [x], grad_all, grad_norms)
    terms += t
    loss, t = g_loss(model, p, x, y_org, y_trg, -lam if fault == "g_ref_ds_sign" else lam, hp, x_ref=x_ref,
                     x_ref2=x_ref2)
    _step(p, opts, ("generator",) + (("mapping_network", "style_encoder") if fault == "ref_steps_fe" else ()), loss,
          [x], grad_all, grad_norms)
    terms += t
    if ema is not None:
        with torch.no_grad():
            for k, e in ema.items():
                e.copy_(torch.lerp(p[k], e, hp.ema_decay))
    return torch.stack([t.detach().float() for t in terms])


# -------------------------------------------------------------- operations --


@functools.lru_cache(maxsize=8)
def _flops(cfg_json: str) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    model, hp = Model.from_config(cfg), Hyper.from_config(cfg)
    b, d = cfg["batch_size"], cfg["image_dim"]
    meta = dict(device="meta")
    p = {k: torch.empty(s, **meta).requires_grad_(True) for k, s in model.shapes().items()}
    img = lambda: torch.empty((b, 3, d, d), **meta)  # noqa: E731
    lab = lambda: torch.zeros((b,), dtype=torch.long, **meta)  # noqa: E731
    z = lambda: torch.empty((b, model.latent_dim), **meta)  # noqa: E731
    with FlopCounterMode(display=False) as counter:
        iteration(model, p, None, None, (img(), img(), img(), lab(), lab()), {"z": z(), "z2": z()}, 0, hp,
                  grad_all=True)
    return float(counter.get_total_flops())


def iteration_flops(cfg: dict) -> float:
    """Operations of one iteration as the published code runs it (every tap
    of every convolution and matrix product: the 24 forwards, R1's double
    backward, and the gradients ``backward()`` takes of every parameter and
    of the real images)."""
    out = _flops(json.dumps(cfg, sort_keys=True))
    if not math.isfinite(out) or out <= 0:
        raise ValueError(f"no operations counted for {cfg.get('image_dim')}")
    return out
