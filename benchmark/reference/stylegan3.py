"""Plain StyleGAN3-T in float32 PyTorch: the yardstick of the
``stylegan3-t-afhqv2-512`` cell, and what the port's CPU tests compare with.

Written from the published code (github.com/NVlabs/stylegan3,
arXiv:2106.12423): ``training/networks_stylegan3.py`` (``SynthesisInput``,
``SynthesisLayer``, ``SynthesisNetwork``, ``modulated_conv2d``),
``torch_utils/ops/filtered_lrelu.py``'s ``_filtered_lrelu_ref`` and
``upfirdn2d.py``'s ``_upfirdn2d_ref``, ``training/loss.py`` and
``training/training_loop.py`` as ``train.py --cfg=stylegan3-t`` sets them.
The discriminator, the losses' plumbing, the Adams and the chunking are
``benchmark/reference/stylegan2.py``'s, imported as they are.

- Mapping: z over the root of its mean square, ``mapping_layers`` FCs
  (``lr_mul`` 0.01, ``lrelu * sqrt(2)``); w broadcast to the 16 layers;
  ``w_avg <- lerp(mean w, w_avg, 0.998)`` in Dmain's G pass alone.
- Synthesis input: Fourier features (frequencies and phases rotated and
  translated by the affine of w, faded out of band, mixed by the weight
  over ``sqrt(C)``).
- 14 layers and ToRGB at the published schedule (:func:`schedule`, with
  its own Kaiser filter design, :func:`kaiser_lowpass`). A layer: in the
  EMA pass ``magnitude_ema <- lerp(mean x^2, magnitude_ema, 0.5 ** (B /
  20000))`` first; then the grouped modulated conv as published (the
  weight and styles pre-normalised, demodulated, times ``rsqrt`` of the
  EMA; ToRGB neither, its styles over ``sqrt(cin)``), padding ``k - 1``;
  then ``_filtered_lrelu_ref``'s four steps: the bias; upfirdn2d up by 2
  or 4 (zero insertion, padding or cropping, the filter along each axis,
  gain up^2); ``lrelu(0.2) * sqrt(2)`` clamped at 256; upfirdn2d down by 2
  (ToRGB: the bias, clamped). The image times 0.25.
- One iteration: Gmain ``softplus(-D(G(z)))`` stepping G (Adam lr 0.0025,
  betas (0, 0.99), no lazy ratio: G has no regularisation phase); Dmain
  ``softplus(D(G(z))) + softplus(-D(x))`` stepping D (lr and betas with
  the lazy ratio 16 / 17); on ``it % 16 == 0`` Dreg ``sum (dD/dx)^2 *
  gamma / 2 * 16``; the EMA of G with ``ema_nimg = min(ema_kimg * 1000,
  it * B * ema_rampup)``, its buffers copied.

The LeakyReLU is ``where(x.detach() > 0, x, 0.2 x)`` and the clamp
``clamp``, as in ``stylegan2.py``. Parameters and buffers are dicts of the
published ``state_dict`` names; :func:`init_params` draws the published
init from a seed. Nothing here imports the program under test.

Departures from the published code: one card takes the 8-GPU batch of 32
(minibatch-stddev groups of 4 strided over it, the magnitude EMAs and
``w_avg`` over all 32); the draws come from the caller; the published
2-D depthwise conv of the zero-inserted map runs as one banded product per
axis (:func:`fir1d`: the same sums with zero terms added, held to the
published form by the tests), whose output steps by 2 where the published
reference filters every sample and keeps every second; ``chunk`` samples
at a time (whole minibatch-stddev groups): Dmain's G pass runs layer by
layer over the chunks, so that each EMA sees the whole batch's input, and
Gmain's G pass runs each chunk on its own, where the style normalisation
sees the chunk alone (the demodulation cancels it).

``Precision("fp8")`` is the control. ``fault`` plants one of four faults
in the reference's place: ``base_rate_lrelu`` (the activation before the
up filter, at the input's rate), ``pad_lo`` (each filtered layer's leading
padding one sample more, its trailing one less), ``no_transform`` (the
Fourier features without the per-sample rotation and translation) and
``frozen_magnitude`` (every ``magnitude_ema`` held at 1).
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import stylegan2 as sg2
from benchmark.reference.littlegan import F32, Precision, no_tf32  # noqa: F401 (no_tf32: the driver's)

Params = Dict[str, torch.Tensor]
LOSSES = sg2.LOSSES
FAULTS = ("base_rate_lrelu", "pad_lo", "no_transform", "frozen_magnitude")
SQRT2 = math.sqrt(2.0)
W_AVG_BETA = 0.998
NUM_LAYERS, NUM_CRITICAL, MARGIN = 14, 2, 10
FIRST_CUTOFF, FIRST_STOPBAND, LAST_STOPBAND_REL = 2.0, 2 ** 2.1, 2 ** 0.3
CLAMP = 256.0


# ------------------------------------------------------------------ schedule --


def kaiser_lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray:
    """``scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)``, float64."""
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * np.pi * width / nyq + 7.95
    beta = 0.1102 * (atten - 8.7) if atten > 50 else (0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
                                                      if atten > 21 else 0.0)
    n = np.arange(numtaps)
    alpha = (numtaps - 1) / 2
    window = np.i0(beta * np.sqrt(1 - ((n - alpha) / alpha) ** 2)) / np.i0(beta)
    h = (cutoff / nyq) * np.sinc((cutoff / nyq) * (n - alpha)) * window
    return h / h.sum()


class Layer(NamedTuple):
    name: str
    cin: int
    cout: int
    in_size: int
    out_size: int
    torgb: bool
    up: int
    down: int
    fu: Optional[np.ndarray]
    fd: Optional[np.ndarray]
    pad: Tuple[int, int]


def schedule(res: int, channel_base: int, channel_max: int):
    """((channels, size, sampling rate, bandwidth) of the input, the layers)."""
    exps = np.minimum(np.arange(NUM_LAYERS + 1) / (NUM_LAYERS - NUM_CRITICAL), 1)
    cut = FIRST_CUTOFF * (res / 2 / FIRST_CUTOFF) ** exps
    stop = FIRST_STOPBAND * (res / 2 * LAST_STOPBAND_REL / FIRST_STOPBAND) ** exps
    sr = np.exp2(np.ceil(np.log2(np.minimum(stop * 2, res))))
    half = np.maximum(stop, sr / 2) - cut
    size = sr + 2 * MARGIN
    size[-2:] = res
    ch = np.rint(np.minimum(channel_base / 2 / cut, channel_max))
    ch[-1] = 3
    layers = []
    for i in range(NUM_LAYERS + 1):
        j, torgb = max(i - 1, 0), i == NUM_LAYERS
        tmp = max(sr[j], sr[i]) * (1 if torgb else 2)
        up, down = int(round(tmp / sr[j])), int(round(tmp / sr[i]))
        ut = 6 * up if up > 1 and not torgb else 1
        dt = 6 * down if down > 1 and not torgb else 1
        fu = kaiser_lowpass(ut, cut[j], half[j] * 2, tmp) if ut > 1 else None
        fd = kaiser_lowpass(dt, cut[i], half[i] * 2, tmp) if dt > 1 else None
        k = 1 if torgb else 3
        total = (int(size[i]) - 1) * down + 1 - (int(size[j]) + k - 1) * up + ut + dt - 2
        lo = (total + up) // 2
        layers.append(Layer(f"L{i}_{int(size[i])}_{int(ch[i])}", int(ch[j]), int(ch[i]), int(size[j]), int(size[i]),
                            torgb, up, down, fu, fd, (lo, total - lo)))
    return (int(ch[0]), int(size[0]), float(sr[0]), float(cut[0])), layers


# ----------------------------------------------------------------------- ops --


_COUNTING = [False]  # set while counting operations (:func:`phase_flops`)


FIR_BLOCK = 64  # outputs per block of :func:`fir1d`'s banded product (a quarter of it where it steps down)


def _banded(x, k, axis: int, up: int, down: int, lo: int, hi: int):
    """:func:`fir1d`'s forward."""
    taps, n_in = k.shape[0], x.shape[axis]
    n_out = (n_in * up + lo + hi - taps) // down + 1
    block = FIR_BLOCK if down == 1 else FIR_BLOCK // 4
    step = block * down // up  # input samples between blocks
    first = -lo // up  # the first input sample block 0 reads
    width = (taps - 1 + (block - 1) * down - lo) // up - first + 1
    r = torch.arange(width, device=k.device)[:, None]
    t = (first + r) * up + lo - torch.arange(block, device=k.device)[None, :] * down  # the tap joining r to each output
    band = torch.where((t >= 0) & (t < taps), k[t.clamp(0, taps - 1)], torch.zeros((), dtype=k.dtype, device=k.device))
    blocks = -(-n_out // block)
    need, start = (blocks - 1) * step + width, max(first, 0)
    edges = [0, 0, 0, 0]
    edges[6 - 2 * axis:8 - 2 * axis] = max(-first, 0), max(need + start - n_in - max(-first, 0), 0)
    windows = F.pad(x, edges).narrow(axis, start, need).unfold(axis, width, step)  # the blocks at ``axis``
    if axis == 3:  # (N, C, H, blocks, W) @ (W, B)
        y = windows @ band
    else:  # (B, W) @ (N, C, blocks, W, width): each block's B outputs before the width
        y = band.t() @ windows.transpose(-1, -2)
    return y.flatten(axis, axis + 1).narrow(axis, 0, n_out)


class _Fir1d(torch.autograd.Function):
    """:func:`_banded` with its adjoint as its backward: the flipped filter,
    up and down swapped, the padding that gives the input's length back
    (as the published ``upfirdn2d``'s gradient)."""

    @staticmethod
    def forward(ctx, x, k, axis: int, up: int, down: int, lo: int, hi: int):
        ctx.save_for_backward(k)
        ctx.args = axis, up, down, lo, x.shape[axis]
        return _banded(x, k, axis, up, down, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (k,) = ctx.saved_tensors
        axis, up, down, lo, n_in = ctx.args
        lo_t = k.shape[0] - 1 - lo
        hi_t = n_in * up - g.shape[axis] * down + lo + 1 - up
        return fir1d(g, k.flip(0), axis, down, up, lo_t, hi_t), None, None, None, None, None, None


def fir1d(x, k, axis: int, up: int, down: int, lo: int, hi: int):
    """One axis of ``_upfirdn2d_ref``: zero insertion (``up - 1`` zeros
    after each sample), padding by ``lo`` and ``hi`` (cropping where
    negative), the correlation with ``k`` and every ``down``-th sample. As
    a banded product: each block of B outputs is the (W, B) matrix of the
    taps that reach them times the W input samples they read, so the
    inserted zeros are never stored or multiplied; the same sums as the
    zero-inserted conv, with zero terms added (``tests/test_torch_stylegan3.py``
    holds the two equal, forward and gradient)."""
    return _Fir1d.apply(x, k, axis, up, down, lo, hi)


def upfirdn2d(x, f, up: int = 1, down: int = 1, pad: Tuple[int, int] = (0, 0), gain: float = 1.0):
    """``_upfirdn2d_ref`` with a separable 1-D filter ``f`` and one padding
    on both axes, one axis at a time (along the rows, then the columns):
    :func:`fir1d` with the filter flipped (the published conv is a
    correlation) and times ``sqrt(gain)``."""
    n, c, h, w = x.shape
    if _COUNTING[0]:  # the count leaves S6's filters out; the map keeps its shape
        return F.adaptive_avg_pool2d(x, [(s * up + pad[0] + pad[1] - f.shape[0]) // down + 1 for s in (h, w)])
    k = (f * gain ** 0.5).flip(0)
    for axis in (3, 2):
        x = fir1d(x, k, axis, up, down, *pad)
    return x


def filtered_lrelu(x, fu, fd, b, up: int, down: int, pad: Tuple[int, int], gain: float = SQRT2,
                   slope: float = 0.2, clamp: float = CLAMP, base_rate: bool = False):
    """``_filtered_lrelu_ref``: the bias, up, ``lrelu * gain`` clamped, down
    (``base_rate``: the planted fault, the activation before the up filter)."""
    x = x + b.reshape(1, -1, 1, 1)
    act = lambda v: (torch.where(v.detach() > 0, v, slope * v) * gain).clamp(-clamp, clamp)  # noqa: E731
    if base_rate:
        x = act(x)
    x = upfirdn2d(x, fu, up=up, pad=pad, gain=up ** 2)
    if not base_rate:
        x = act(x)
    return upfirdn2d(x, fd, down=down)


def modulated_conv2d(x, w, s, demodulate: bool, padding: int, input_gain, pr: Precision = F32):
    """The published grouped form; ``input_gain`` a () tensor."""
    n = x.shape[0]
    o, i, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w[None] * s[:, None, :, None, None]
    if demodulate:
        w = w * (w.square().sum([2, 3, 4]) + 1e-8).rsqrt()[:, :, None, None, None]
    w = w * input_gain
    if _COUNTING[0]:  # the same products as one shared-weight conv (FlopCounterMode over-counts a grouped backward)
        return F.conv2d(x, w[0], padding=padding)
    y = F.conv2d(pr.q(x.reshape(1, -1, *x.shape[2:])), pr.q(w.reshape(-1, i, kh, kw)), padding=padding, groups=n)
    return pr.q(y.reshape(n, -1, *y.shape[2:]))


# --------------------------------------------------------------------- model --


@dataclass
class Model(sg2.Model):
    """StyleGAN3-T's G with StyleGAN2's D, sizes read from a configuration file."""

    image_dim: int = 512
    channel_base: int = 32768
    mapping_layers: int = 2
    mbstd_group: int = 4
    batch_size: int = 32

    @classmethod
    def from_config(cls, cfg: dict, pr: Precision = F32, fault: Optional[str] = None) -> "Model":
        keys = ("image_dim", "channel_base", "channel_max", "z_dim", "w_dim", "mapping_layers", "mapping_lr_mul",
                "mbstd_group", "conv_clamp", "batch_size")
        return cls(**{k: cfg[k] for k in keys if k in cfg}, pr=pr, fault=fault)

    @property
    def num_ws(self) -> int:
        return NUM_LAYERS + 2

    @functools.cached_property
    def plan(self):
        return schedule(self.image_dim, self.channel_base, self.channel_max)

    @property
    def magnitude_beta(self) -> float:
        return 0.5 ** (self.batch_size / 20000)

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        out: Dict[str, Tuple[int, ...]] = {}
        for i in range(self.mapping_layers):
            out[f"G.mapping.fc{i}.weight"] = (self.w_dim, self.z_dim if i == 0 else self.w_dim)
            out[f"G.mapping.fc{i}.bias"] = (self.w_dim,)
        c = self.plan[0][0]
        out["G.synthesis.input.weight"] = (c, c)
        out["G.synthesis.input.affine.weight"] = (4, self.w_dim)
        out["G.synthesis.input.affine.bias"] = (4,)
        for layer in self.plan[1]:
            key, k = f"G.synthesis.{layer.name}", 1 if layer.torgb else 3
            out[key + ".weight"] = (layer.cout, layer.cin, k, k)
            out[key + ".bias"] = (layer.cout,)
            out[key + ".affine.weight"] = (layer.cin, self.w_dim)
            out[key + ".affine.bias"] = (layer.cin,)
        out.update({k: s for k, s in super().shapes().items() if k.startswith("D.")})
        return out

    def buffers(self, gen: torch.Generator, device) -> Params:
        """The input's frequencies and phases drawn from ``gen``; every
        ``magnitude_ema`` 1, ``w_avg`` 0."""
        c, _, _, bw = self.plan[0]
        freqs = torch.randn((c, 2), generator=gen, device=device)
        radii = freqs.square().sum(1, keepdim=True).sqrt()
        out = {"G.synthesis.input.freqs": freqs / (radii * radii.square().exp().pow(0.25)) * bw,
               "G.synthesis.input.phases": torch.rand((c,), generator=gen, device=device) - 0.5}
        for layer in self.plan[1]:
            out[f"G.synthesis.{layer.name}.magnitude_ema"] = torch.ones((), device=device)
        out["G.mapping.w_avg"] = torch.zeros(self.w_dim, device=device)
        return out

    # G
    def synthesis_input(self, p: Params, buf: Params, w):
        c, size, sr, bw = self.plan[0]
        t = sg2.fc(w, p["G.synthesis.input.affine.weight"], p["G.synthesis.input.affine.bias"])
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        n = w.shape[0]
        m_r = torch.eye(3, device=w.device)[None].repeat(n, 1, 1)
        m_t = torch.eye(3, device=w.device)[None].repeat(n, 1, 1)
        if self.fault != "no_transform":
            m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
            m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        transforms = m_r @ m_t
        freqs = buf["G.synthesis.input.freqs"][None]
        phases = buf["G.synthesis.input.phases"][None] + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amps = (1 - (freqs.norm(dim=2) - bw) / (sr / 2 - bw)).clamp(0, 1)
        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = theta[1, 1] = 0.5 * size / sr
        grid = F.affine_grid(theta[None], [1, 1, size, size], align_corners=False)
        x = (grid.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
        x = torch.sin((x + phases[:, None, None]) * (2 * math.pi)) * amps[:, None, None]
        x = x @ (p["G.synthesis.input.weight"] / math.sqrt(c)).t()
        return x.permute(0, 3, 1, 2)

    def layer(self, p: Params, buf: Params, layer: Layer, x, w):
        key = f"G.synthesis.{layer.name}"
        gain_in = (torch.ones((), device=x.device) if self.fault == "frozen_magnitude"
                   else buf[key + ".magnitude_ema"]).rsqrt()
        s = sg2.fc(w, p[key + ".affine.weight"], p[key + ".affine.bias"])
        if layer.torgb:
            y = modulated_conv2d(x, p[key + ".weight"], s / math.sqrt(layer.cin), False, 0, gain_in, self.pr)
            return sg2.bias_act(y, p[key + ".bias"], False, 1.0, CLAMP)
        y = modulated_conv2d(x, p[key + ".weight"], s, True, 2, gain_in, self.pr)
        f = lambda a: None if a is None else torch.as_tensor(a, dtype=x.dtype, device=x.device)  # noqa: E731
        pad = (layer.pad[0] + 1, layer.pad[1] - 1) if self.fault == "pad_lo" else layer.pad
        return filtered_lrelu(y, f(layer.fu), f(layer.fd), p[key + ".bias"], layer.up, layer.down, pad,
                              base_rate=self.fault == "base_rate_lrelu")

    def synthesis(self, p: Params, buf: Params, ws):
        """(N, 3, H, W) images of (N, num_ws, w_dim) styles, no EMA moved."""
        x = self.synthesis_input(p, buf, ws[:, 0])
        for i, layer in enumerate(self.plan[1]):
            x = self.layer(p, buf, layer, x, ws[:, i + 1])
        return x * 0.25

    @torch.no_grad()
    def synthesis_ema(self, p: Params, buf: Params, ws, parts: List[torch.Tensor]):
        """Dmain's G pass: layer by layer over the chunks ``parts``, each
        ``magnitude_ema`` moved on the whole batch's input before it is read."""
        n = ws.shape[0]
        x = torch.cat([self.synthesis_input(p, buf, ws[i, 0]) for i in parts])
        order = torch.cat(parts)
        for j, layer in enumerate(self.plan[1]):
            key = f"G.synthesis.{layer.name}.magnitude_ema"
            if self.fault != "frozen_magnitude":
                buf[key] = x.square().mean().lerp(buf[key], self.magnitude_beta)
            off, out = 0, []
            for i in parts:
                out.append(self.layer(p, buf, layer, x[off:off + len(i)], ws[i, j + 1]))
                off += len(i)
            x = torch.cat(out)
        img = torch.empty_like(x)
        img[order.to(x.device)] = x * 0.25
        return img[:n]


def init_params(model: Model, gen: torch.Generator, device) -> Tuple[Params, Params]:
    """(parameters, buffers): StyleGAN2's init in one normal draw (every
    weight N(0, 1), the mapping's over ``lr_mul``, the affines' biases 1,
    other biases 0), the input affine's weight 0 and bias ``[1, 0, 0, 0]``;
    then the buffers (:meth:`Model.buffers`)."""
    p = sg2.init_params(model.shapes(), gen, device, model.mapping_lr_mul)
    p["G.synthesis.input.affine.weight"] = torch.zeros_like(p["G.synthesis.input.affine.weight"])
    p["G.synthesis.input.affine.bias"] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    return p, model.buffers(gen, device)


# ------------------------------------------------------------------ training --


@dataclass
class Hyper(sg2.Hyper):
    batch_size: int = 32
    lr: float = 0.0025
    d_lr: float = 0.002
    r1_gamma: float = 8.2
    pl_weight: float = 0.0
    style_mixing: float = 0.0
    g_reg_interval: int = 0
    d_reg_interval: int = 16
    ema_kimg: float = 10.0
    ema_rampup: float = 0.05

    def runs(self, it: int) -> Tuple[bool, bool]:
        return False, self.r1_gamma != 0 and it % self.d_reg_interval == 0

    def ema_beta(self, it: int) -> float:
        nimg = self.ema_kimg * 1000
        if self.ema_rampup > 0:
            nimg = min(nimg, it * self.batch_size * self.ema_rampup)
        return 0.5 ** (self.batch_size / max(nimg, 1e-8))


def adams(p: Params, hp: Hyper) -> Dict[str, torch.optim.Adam]:
    """G's Adam (no regularisation phase: lr and betas as given) and D's (the lazy ratio)."""
    c = hp.d_reg_interval / (hp.d_reg_interval + 1)
    g = [v for k, v in p.items() if k.startswith("G.")]
    d = [v for k, v in p.items() if k.startswith("D.")]
    return {"G": torch.optim.Adam(g, lr=hp.lr, betas=(hp.beta_1, hp.beta_2), eps=1e-8),
            "D": torch.optim.Adam(d, lr=(hp.d_lr or hp.lr) * c, betas=(hp.beta_1 ** c, hp.beta_2 ** c), eps=1e-8)}


@dataclass
class Run:
    buf: Params
    ema: Optional[Params]


def new_run(p: Params, buf: Params, ema: bool = True) -> Run:
    b = {k: v.clone() for k, v in buf.items()}
    e = None
    if ema:
        e = {k: v.detach().clone() for k, v in p.items() if k.startswith("G.")}
        e.update({k: v.clone() for k, v in b.items() if k.endswith(("magnitude_ema", "w_avg"))})
    return Run(b, e)


def styles(model: Model, p: Params, z):
    return model.mapping(p, z)[:, None].repeat(1, model.num_ws, 1)


def iteration(model: Model, p: Params, opts, run: Run, x_real, draws: dict, it: int, hp: Hyper,
              chunk: Optional[int] = None, grad_norms: Optional[dict] = None):
    """One iteration in place on ``p``, ``opts`` and ``run``: the (6,)
    terms (:data:`LOSSES`; the path-length terms 0). ``draws``:
    ``g_main`` and ``d_main`` (each ``z``). ``opts`` None: no update
    (counting)."""
    b = x_real.shape[0]
    parts = sg2.chunks(b, model.mbstd_group, chunk)
    zero = torch.zeros((), device=x_real.device)
    _, reg_d = hp.runs(it)

    z = draws["g_main"]["z"]
    acc = []

    def gmain(i):
        img = model.synthesis(p, run.buf, styles(model, p, z[i]))
        loss = F.softplus(-model.discriminator(p, img)).sum() / b
        acc.append(loss.detach())
        return loss

    sg2._step(p, opts, "G", [functools.partial(gmain, i) for i in parts], grad_norms)
    terms = [sum(acc), zero]

    z = draws["d_main"]["z"]
    with torch.no_grad():
        w = model.mapping(p, z)
        run.buf["G.mapping.w_avg"] = w.mean(0).lerp(run.buf["G.mapping.w_avg"], W_AVG_BETA)
        fake_img = model.synthesis_ema(p, run.buf, w[:, None].repeat(1, model.num_ws, 1), parts)
    fake_acc, real_acc = [], []

    def dmain(i):
        fake = F.softplus(model.discriminator(p, fake_img[i])).sum() / b
        real = F.softplus(-model.discriminator(p, x_real[i])).sum() / b
        fake_acc.append(fake.detach())
        real_acc.append(real.detach())
        return fake + real

    sg2._step(p, opts, "D", [functools.partial(dmain, i) for i in parts], grad_norms)
    terms += [sum(fake_acc), sum(real_acc)]

    if reg_d:
        pen_acc = []

        def dreg(i):
            x = x_real[i].detach().requires_grad_(True)
            with sg2.no_weight_gradients():
                (g,) = torch.autograd.grad(model.discriminator(p, x).sum(), x, create_graph=True)
            pen = g.square().sum((1, 2, 3))
            pen_acc.append(pen.detach().sum() / b)
            return (pen * (hp.r1_gamma / 2)).sum() / b * hp.d_reg_interval

        sg2._step(p, opts, "D", [functools.partial(dreg, i) for i in parts], grad_norms)
        terms.append(sum(pen_acc))
    else:
        terms.append(zero)

    if run.ema is not None:
        beta = hp.ema_beta(it)
        with torch.no_grad():
            for k, e in run.ema.items():
                e.copy_(run.buf[k] if k in run.buf else torch.lerp(p[k], e, beta))
    terms.append(zero)
    return torch.stack([torch.as_tensor(t, device=x_real.device).detach().float() for t in terms])


# -------------------------------------------------------------- operations --


@functools.lru_cache(maxsize=8)
def _phase_flops(cfg_json: str) -> Tuple[float, float, float]:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    model, hp = Model.from_config(cfg), Hyper.from_config(cfg)
    b, dim = cfg["batch_size"], cfg["image_dim"]
    meta = dict(device="meta")
    p = {k: torch.empty(s, **meta).requires_grad_(True) for k, s in model.shapes().items()}
    c = model.plan[0][0]
    buf = {"G.synthesis.input.freqs": torch.empty((c, 2), **meta),
           "G.synthesis.input.phases": torch.empty((c,), **meta),
           "G.mapping.w_avg": torch.empty((model.w_dim,), **meta),
           **{f"G.synthesis.{layer.name}.magnitude_ema": torch.empty((), **meta) for layer in model.plan[1]}}
    x = torch.empty((b, 3, dim, dim), **meta)
    draws = {"g_main": {"z": torch.empty((b, model.z_dim), **meta)}, "d_main": {"z": torch.empty((b, model.z_dim),
                                                                                                  **meta)}}
    out = []
    for it in (1, 0):  # iteration 1 runs no regularisation, iteration 0 R1
        with FlopCounterMode(display=False) as counter, _no_filter_ops():
            iteration(model, p, None, Run(dict(buf), None), x, draws, it, hp)
        out.append(float(counter.get_total_flops()))
    main, dreg = out[0], out[1] - out[0]
    return main, dreg, main + dreg / hp.d_reg_interval


class _no_filter_ops:
    """Inside: the filtered LeakyReLU's resampling convs are left out of the
    count (they run on the CUDA cores; S6's roofline counts them), and each
    modulated conv is counted as one conv of the batch with one weight."""

    def __enter__(self):
        _COUNTING[0] = True

    def __exit__(self, *exc):
        _COUNTING[0] = False


def phase_flops(cfg: dict) -> Dict[str, float]:
    """Operations of the phases as the published code runs them (every tap
    of every convolution and matrix product of G and D, forwards and the
    gradients the phases take; not the S6 resampling filters): ``main``
    (Gmain + Dmain), ``d_reg`` and ``iteration``, one iteration averaged
    over the lazy period."""
    main, dreg, avg = _phase_flops(json.dumps(cfg, sort_keys=True))
    if not all(math.isfinite(v) and v > 0 for v in (main, dreg, avg)):
        raise ValueError(f"no operations counted for {cfg.get('image_dim')}")
    return {"main": main, "d_reg": dreg, "iteration": avg}


def iteration_flops(cfg: dict) -> float:
    return phase_flops(cfg)["iteration"]
