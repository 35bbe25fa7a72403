"""StyleGAN3-T (Karras et al., NeurIPS 2021, arXiv:2106.12423) as
``nn.Module``s: ``training/networks_stylegan3.py`` of
github.com/NVlabs/stylegan3 in its translation-equivariant configuration
(``train.py --cfg=stylegan3-t``), with ``models/stylegan2.py``'s
discriminator.

:class:`StyleGAN3` holds ``G`` and ``D``; a parameter's or buffer's name
under each is the published ``state_dict`` key
(``G.synthesis.L7_148_483.weight``, ``G.synthesis.input.freqs``,
``D.b512.fromrgb.weight``):

- mapping: ``models/stylegan2.py``'s :class:`MappingNetwork` (z over the
  root of its mean square, ``mapping_layers`` FCs with ``lr_mul`` 0.01),
  ``w_avg`` tracked with beta 0.998, only in the pass that updates the
  EMAs (Dmain's); w broadcast to the :func:`num_ws` layers, no mixing.
- :class:`SynthesisInput`: Fourier features in place of a learned
  constant: ``channels`` sinusoids over ``size``^2 samples at
  ``sampling_rate``, frequencies drawn in a disc of radius ``bandwidth``,
  each sample's frequencies and phases rotated and translated by an
  affine of w (weight init 0, bias ``[1, 0, 0, 0]``), faded out of band,
  then mixed by a ``channels`` x ``channels`` weight over ``sqrt(C)``.
- :class:`SynthesisLayer`: ``num_layers`` layers at cutoffs and stopbands
  that grow geometrically (:func:`schedule`), then ToRGB. A layer keeps
  ``magnitude_ema``, the running mean square of its input (beta
  ``0.5 ** (batch / 20000)``, updated in the EMA pass before it is read),
  and scales its input by its inverse root. Its modulated 3x3 conv runs
  NVlabs' ``modulated_conv2d`` in the non-fused form: the weight over the
  root of its mean square per output, the styles over the root of their
  mean square over the whole (batch, channel) tensor, ``x * (s * g_in)``,
  the shared-weight conv with padding 2 (a full conv: the map grows by 2),
  then ``* d[n, o]`` with ``d = rsqrt(sum_{i, k} (W s)^2 + 1e-8)`` (formed
  as ``s^2 @ sum_k W^2``), which S6 takes in its read (the conv is one
  Function, :class:`ModulatedConv`, that keeps x and s for its backward
  and not ``x * s`` besides). S6
  (``ops/cuda/filtered_lrelu.py``): the bias, upsampling by 2 or 4 through
  a Kaiser low-pass filter of 6 taps a factor, ``lrelu(0.2) * sqrt(2)``
  clamped at 256, downsampling by 2 through a 12-tap filter, the padding as
  published. ToRGB: a 1x1 conv with styles times ``1 / sqrt(cin)`` and the
  input gain, no demodulation, then S5 (``ops/cuda/bias_act.py``): the
  bias, clamped at 256, linear.
- the image is ToRGB's output times 0.25, in float32.
- D: ``models/stylegan2.py``'s :class:`Discriminator` (resnet, minibatch
  stddev, S4 and S5), at ``channel_base`` and ``mbstd_group`` from the
  configuration.

Parameters are float32. Convolutions and S6 run in ``cfg.compute_dtype``
over channels-last maps; the mapping, the affines, the Fourier features,
the demodulation and the image stay float32. Departures: bf16 at every
layer (the published code runs fp16 on the layers whose sampling rate
times 16 exceeds the resolution, float32 below); the EMAs and the style
normalisation see the whole batch (eight published GPUs each see their
own 4 samples; the demodulation cancels the style normalisation, up to its
1e-8). Buffers the model reads but never changes: the filters, ``freqs``,
``phases`` and ``transform`` (the identity).

:func:`init_params` is the published init from a seed. Counters
``stylegan3.mapping``, ``.synthesis``, ``.discriminator``: one per network
call. Spans (under a profiler only): ``stylegan3.input`` (the Fourier
features) and ``stylegan3.magnitude_ema`` (each EMA update).
:func:`check_supported` refuses what StyleGAN2's does, and image sizes
below 16.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models import stylegan2
from littlegan_tpu_torch.models.stylegan2 import FC, LAYOUT, modulate
from littlegan_tpu_torch.ops.cuda._build import LaunchCounter
from littlegan_tpu_torch.ops.cuda.bias_act import bias_act
from littlegan_tpu_torch.ops.cuda.filtered_lrelu import FORMS, filtered_lrelu, make_spec
from littlegan_tpu_torch.utils.spans import span

CALLS = {name: LaunchCounter(f"stylegan3.{name}") for name in ("mapping", "synthesis", "discriminator")}
NUM_LAYERS = 14  # layers before ToRGB
NUM_CRITICAL = 2  # critically sampled layers at the end
FIRST_CUTOFF = 2.0
FIRST_STOPBAND = 2 ** 2.1
LAST_STOPBAND_REL = 2 ** 0.3
MARGIN = 10  # samples outside the image on each side
OUTPUT_SCALE = 0.25
CONV_KERNEL = 3
FILTER_SIZE = 6  # taps per factor of a resampling filter
LRELU_UPSAMPLING = 2
CLAMP = 256.0
SLOPE = 0.2
W_AVG_BETA = 0.998


def num_ws() -> int:
    """Style vectors the synthesis reads: the input's, one a layer, ToRGB's."""
    return NUM_LAYERS + 2


def layout(cfg: Config) -> Tuple[int, int]:
    """(style vectors, noise samples per image) a G pass reads: no noise."""
    return num_ws(), 0


class Layer(NamedTuple):
    """One synthesis layer of :func:`schedule`."""

    name: str
    cin: int
    cout: int
    in_size: int
    out_size: int
    torgb: bool
    up: int
    down: int
    up_filter: Tuple[float, ...]  # () for none
    down_filter: Tuple[float, ...]
    padding: Tuple[int, int]  # (lo, hi), the same on both axes

    @property
    def kernel(self) -> int:
        return 1 if self.torgb else CONV_KERNEL


class InputPlan(NamedTuple):
    channels: int
    size: int
    sampling_rate: float
    bandwidth: float


def kaiser_lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray:
    """``scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)``: a
    windowed sinc whose Kaiser window's beta meets the transition width
    (``kaiser_atten``, ``kaiser_beta``), scaled to unit gain at 0; float64,
    symmetric."""
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * math.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = np.arange(numtaps) - (numtaps - 1) / 2
    c = cutoff / nyq
    h = c * np.sinc(c * m) * np.kaiser(numtaps, beta)
    h = h / h.sum()
    return (h + h[::-1]) / 2


def schedule(image_dim: int, channel_base: int, channel_max: int, channels: int = 3) -> Tuple[InputPlan, List[Layer]]:
    """``SynthesisNetwork.__init__``'s layer parameters at ``image_dim``:
    cutoffs and stopbands from ``FIRST_CUTOFF`` and ``FIRST_STOPBAND`` to
    ``image_dim / 2`` and ``image_dim / 2 * LAST_STOPBAND_REL`` with the
    exponent ``min(i / (NUM_LAYERS - NUM_CRITICAL), 1)``; sampling rates the
    power of two at ``min(2 * stopband, image_dim)`` rounded up; sizes the
    rate plus the margins (the last two the image); widths
    ``rint(min(channel_base / 2 / cutoff, channel_max))``."""
    last_cutoff = image_dim / 2
    exps = np.minimum(np.arange(NUM_LAYERS + 1) / (NUM_LAYERS - NUM_CRITICAL), 1)
    cutoffs = FIRST_CUTOFF * (last_cutoff / FIRST_CUTOFF) ** exps
    stopbands = FIRST_STOPBAND * (last_cutoff * LAST_STOPBAND_REL / FIRST_STOPBAND) ** exps
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, image_dim))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + MARGIN * 2
    sizes[-2:] = image_dim
    widths = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    widths[-1] = channels
    layers = []
    for i in range(NUM_LAYERS + 1):
        prev, torgb = max(i - 1, 0), i == NUM_LAYERS
        k = 1 if torgb else CONV_KERNEL
        tmp_rate = max(rates[prev], rates[i]) * (1 if torgb else LRELU_UPSAMPLING)
        up, down = int(np.rint(tmp_rate / rates[prev])), int(np.rint(tmp_rate / rates[i]))
        up_taps = FILTER_SIZE * up if up > 1 and not torgb else 1
        down_taps = FILTER_SIZE * down if down > 1 and not torgb else 1
        fu = () if up_taps == 1 else tuple(kaiser_lowpass(up_taps, cutoffs[prev], half_widths[prev] * 2, tmp_rate))
        fd = () if down_taps == 1 else tuple(kaiser_lowpass(down_taps, cutoffs[i], half_widths[i] * 2, tmp_rate))
        pad_total = (int(sizes[i]) - 1) * down + 1 - (int(sizes[prev]) + k - 1) * up + up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        out = int(sizes[i])
        layers.append(Layer(f"L{i}_{out}_{int(widths[i])}", int(widths[prev]), int(widths[i]), int(sizes[prev]), out,
                            torgb, up, down, fu, fd, (pad_lo, pad_total - pad_lo)))
    return InputPlan(int(widths[0]), int(sizes[0]), float(rates[0]), float(cutoffs[0])), layers


def check_supported(cfg: Config) -> None:
    """StyleGAN2's refusals, then an image size the schedule can take."""
    stylegan2.check_supported(cfg)
    if cfg.image_dim < 16:
        raise ValueError(f"stylegan3 needs an image_dim of at least 16, got {cfg.image_dim}")
    for layer in schedule(cfg.image_dim, cfg.channel_base, cfg.channel_max)[1][:-1]:
        form = (layer.up, len(layer.up_filter), layer.down, len(layer.down_filter))
        if form not in FORMS:
            raise ValueError(f"stylegan3: layer {layer.name} resamples as {form}, which S6 does not take")


class SynthesisInput(nn.Module):
    """The Fourier features: (N, C, size, size) channels-last of (N, w_dim) w."""

    def __init__(self, w_dim: int, plan: InputPlan):
        super().__init__()
        c = plan.channels
        self.plan = plan
        self.weight = nn.Parameter(torch.randn(c, c))
        self.affine = FC(w_dim, 4)
        with torch.no_grad():
            self.affine.weight.zero_()
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        self.register_buffer("transform", torch.eye(3))
        freqs = torch.randn(c, 2)
        radii = freqs.square().sum(1, keepdim=True).sqrt()
        self.register_buffer("freqs", freqs / (radii * radii.square().exp().pow(0.25)) * plan.bandwidth)
        self.register_buffer("phases", torch.rand(c) - 0.5)
        theta = torch.tensor([[0.5 * plan.size / plan.sampling_rate, 0.0, 0.0],
                              [0.0, 0.5 * plan.size / plan.sampling_rate, 0.0]])
        grid = nn.functional.affine_grid(theta[None], [1, 1, plan.size, plan.size], align_corners=False)
        self.register_buffer("grid", grid.reshape(1, plan.size * plan.size, 2), persistent=False)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        plan, n = self.plan, w.shape[0]
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zero, one = torch.zeros_like(t[:, 0]), torch.ones_like(t[:, 0])
        m_r = torch.stack([torch.stack([t[:, 0], -t[:, 1], zero], 1), torch.stack([t[:, 1], t[:, 0], zero], 1),
                           torch.stack([zero, zero, one], 1)], 1)
        m_t = torch.stack([torch.stack([one, zero, -t[:, 2]], 1), torch.stack([zero, one, -t[:, 3]], 1),
                           torch.stack([zero, zero, one], 1)], 1)
        transforms = m_r @ m_t @ self.transform[None]
        freqs = self.freqs[None]
        phases = self.phases[None] + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amps = (1 - (freqs.norm(dim=2) - plan.bandwidth) / (plan.sampling_rate / 2 - plan.bandwidth)).clamp(0, 1)
        x = self.grid @ freqs.transpose(1, 2)  # (N, size^2, C)
        x = torch.sin((x + phases[:, None]) * (2 * math.pi)) * amps[:, None]
        x = x @ (self.weight / math.sqrt(plan.channels)).t()
        return x.reshape(n, plan.size, plan.size, plan.channels).permute(0, 3, 1, 2)


class ModulatedConv(torch.autograd.Function):
    """``conv2d(x * s[n, i], w, padding)`` without bias (first order only),
    saving x and s alone: the backward forms ``x * s`` again for the
    weight's gradient, where autograd would keep both x (for s's gradient)
    and ``x * s`` (for the conv's) through the step; s's gradient is
    ``sum_{h, w} gxs x`` in float32."""

    @staticmethod
    def forward(ctx, x, s, w, padding: int):
        ctx.save_for_backward(x, s, w)
        ctx.padding = padding
        return F.conv2d(modulate(x, s), w, padding=padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, s, w = ctx.saved_tensors
        p = ctx.padding
        xs = modulate(x, s)
        gxs, gw = torch.ops.aten.convolution_backward(g, xs, w, None, [1, 1], [p, p], [1, 1], False, [0, 0], 1,
                                                      [True, ctx.needs_input_grad[2], False])[:2]
        gx = modulate(gxs, s) if ctx.needs_input_grad[0] else None
        gs = None
        if ctx.needs_input_grad[1]:  # float32 products, a few samples at a time (no float32 copy of the maps)
            step = max(1, (1 << 28) // max(1, x[0].numel()))
            gs = torch.cat([(gxs[i:i + step].float() * x[i:i + step].float()).sum((2, 3))
                            for i in range(0, x.shape[0], step)])
        return gx, gs, gw, None


class SynthesisLayer(nn.Module):
    """A modulated conv and S6 (ToRGB: a modulated 1x1 and S5)."""

    def __init__(self, layer: Layer, w_dim: int, batch_size: int):
        super().__init__()
        self.layer = layer
        k = layer.kernel
        self.affine = FC(w_dim, layer.cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(layer.cout, layer.cin, k, k).contiguous(memory_format=LAYOUT))
        self.bias = nn.Parameter(torch.zeros(layer.cout))
        self.register_buffer("magnitude_ema", torch.ones([]))
        self.magnitude_ema_beta = 0.5 ** (batch_size / 20000)
        if not layer.torgb:
            self.register_buffer("up_filter", torch.tensor(layer.up_filter, dtype=torch.float32))
            self.register_buffer("down_filter", torch.tensor(layer.down_filter, dtype=torch.float32))
            conv_out = layer.in_size + k - 1
            lo, hi = layer.padding
            self.spec = make_spec(conv_out, conv_out, layer.up_filter, layer.down_filter, layer.up, layer.down,
                                  (lo, hi, lo, hi), math.sqrt(2.0), SLOPE, CLAMP)

    def forward(self, x: torch.Tensor, w: torch.Tensor, update_emas: bool = False) -> torch.Tensor:
        if update_emas:  # mean(x^2) in float32, read in one pass with no float32 copy of x
            with span("stylegan3.magnitude_ema"), torch.no_grad():
                mean_sq = torch.linalg.vector_norm(x.detach(), dtype=torch.float32).square() / x.numel()
                self.magnitude_ema.copy_(mean_sq.lerp(self.magnitude_ema, self.magnitude_ema_beta))
        gain_in = self.magnitude_ema.rsqrt()
        styles = self.affine(w)
        if self.layer.torgb:
            s = styles * (gain_in / math.sqrt(self.layer.cin))
            y = ModulatedConv.apply(x, s, self.weight.to(x.dtype), 0)
            return bias_act(y, self.bias, act=False)
        wt = self.weight * self.weight.square().mean((1, 2, 3), keepdim=True).rsqrt()
        s = styles * styles.square().mean().rsqrt()
        d = (s.square() @ wt.square().sum((2, 3)).t() + 1e-8).rsqrt()
        y = ModulatedConv.apply(x, s * gain_in, wt.to(x.dtype), self.layer.kernel - 1)
        return filtered_lrelu(y, self.bias, d, self.up_filter, self.down_filter, self.spec)


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.dtype = getattr(torch, cfg.compute_dtype)
        plan, layers = schedule(cfg.image_dim, cfg.channel_base, cfg.channel_max, cfg.image_channel)
        self.input = SynthesisInput(cfg.w_dim, plan)
        self.layer_names = [layer.name for layer in layers]
        for layer in layers:
            setattr(self, layer.name, SynthesisLayer(layer, cfg.w_dim, cfg.batch_size))

    def forward(self, ws: torch.Tensor, noise=None, update_emas: bool = False) -> torch.Tensor:
        """(N, 3, H, W) float32 images (channels-last) of (N, num_ws, w_dim)
        styles (``noise`` is not read: StyleGAN3 has no noise maps); with
        ``update_emas`` every layer's ``magnitude_ema`` moves on its input
        first."""
        CALLS["synthesis"].add()
        w = ws.float().unbind(1)
        with span("stylegan3.input"):
            x = self.input(w[0]).to(self.dtype)
        for name, wl in zip(self.layer_names, w[1:]):
            x = getattr(self, name)(x, wl, update_emas)
        return x.float() * OUTPUT_SCALE


class Generator(nn.Module):
    EMA_PHASES = ("d_main",)  # the G passes that move the EMA buffers (w_avg, magnitude_ema): Dmain's alone

    def __init__(self, cfg: Config):
        super().__init__()
        self.mapping = stylegan2.MappingNetwork(cfg, W_AVG_BETA, CALLS)
        self.synthesis = SynthesisNetwork(cfg)


class StyleGAN3(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        check_supported(cfg)
        self.G = Generator(cfg)
        self.D = stylegan2.Discriminator(cfg, CALLS)


@torch.no_grad()
def init_params(model: StyleGAN3, seed: int) -> StyleGAN3:
    """The published init in place, from ``seed`` (one CPU generator, the
    parameters in order, then the input's frequencies and phases): every
    weight N(0, 1) (an equalized-lr FC's over ``lr_mul``) but the input
    affine's, 0; biases 0, the affines' 1, the input affine's ``[1, 0, 0,
    0]``; ``magnitude_ema`` 1, ``w_avg`` 0."""
    gen = torch.Generator().manual_seed(seed)
    fcs = {name: m for name, m in model.named_modules() if isinstance(m, FC)}
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        if owner == "G.synthesis.input.affine":
            p.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]) if leaf == "bias" else torch.zeros(p.shape))
        elif leaf == "weight":
            lr_mul = fcs[owner].bias_gain if owner in fcs else 1.0
            p.copy_(torch.randn(p.shape, generator=gen) / lr_mul)
        elif leaf == "bias":
            p.fill_(1.0 if owner.endswith("affine") else 0.0)
        else:
            p.zero_()
    inp = model.G.synthesis.input
    freqs = torch.randn(inp.freqs.shape, generator=gen)
    radii = freqs.square().sum(1, keepdim=True).sqrt()
    inp.freqs.copy_(freqs / (radii * radii.square().exp().pow(0.25)) * inp.plan.bandwidth)
    inp.phases.copy_(torch.rand(inp.phases.shape, generator=gen) - 0.5)
    for name, b in model.named_buffers():
        if name.endswith("magnitude_ema"):
            b.fill_(1.0)
    model.G.mapping.w_avg.zero_()
    return model
