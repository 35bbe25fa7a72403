"""StarGAN v2 held channels-last (``models/stargan_v2.py``): its
per-(sample, channel) instance norm + LeakyReLU
(``ops/cuda/channel_norm_lrelu.py``, ``csrc/channel_norm_lrelu.cu``), its
2x2 resampling (``ops/cuda/resample.py``, ``csrc/resample.cu``) and its
convolution epilogue (``ops/cuda/conv_epilogue.py``,
``csrc/conv_epilogue.cu``) over NHWC maps. Imports no JAX.

On the CPU: the plain norm and its backward against ``ops/norm.py``'s
``batch_norm`` composition (IN and AdaIN, then ``F.leaky_relu``), values
and gradients in float32; its moments at a mean 100 times the spread; the
kernel wrappers' checks and splits; the Function refusing a double
backward; the plain resampling against ``F.avg_pool2d`` and
``F.interpolate``, its Functions each other's adjoint to the second
order; a tiny StarGAN v2 against today's NCHW path (the composition,
contiguous weights and activations: ``LAYOUT`` and ``channel_norm_lrelu``
patched) for the four networks and R1, outputs and parameter gradients;
every conv's activations and weight gradients channels-last; the counters,
25 norms a generator pass at 256², and the norm's, pool's, upsample's and
epilogue's calls in one iteration at 256² depth (200 / 100 / 276 / 228 /
408 / 266). The epilogue: the model's plain route against the parent's
arithmetic (the bias inside ``F.conv2d``, then ``(sc + r) / sqrt(2)``) in
float32, outputs and every parameter gradient; its Functions against
finite differences to the second order in float64; its calls per network
pass; the shapes it runs at full width (on the meta device); the backward's
split of the rows.

On a card (marked ``card``; skips without one): the norm kernels against
the plain version at the 8 (C, H) shapes of StarGAN v2's generator at AFHQ
256², batch 8, bf16 and f32, scale shared and per sample; a mean 100
times the spread; CUDA-graph replays equal to eager bit for bit; the
resampling kernel against its plain version; the epilogue's kernels
against the plain version at every (C, H) the cell's iteration runs them,
both forms, bf16 and f32, the column sum bit for bit across calls, and its
refusal of a map that is not channels-last; one eager iteration of the
benchmark's configuration under the profiler: no cuDNN layout transpose
but around the 3-channel and 4x4 convs (listed), the norm counters at 200
/ 100, Adam's updates in ``multi_tensor_apply`` kernels. On the card's
host, which has no JAX: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_stargan_v2_nhwc.py -m card -s``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models import stargan_v2 as sm
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda import channel_norm_lrelu as cn
from littlegan_tpu_torch.ops.cuda import conv_epilogue as ce
from littlegan_tpu_torch.ops.cuda import resample as rs
from littlegan_tpu_torch.training import stargan_v2 as ts
from littlegan_tpu_torch.training.state import create_stargan_state
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CL = torch.channels_last
ALPHA = 0.2
TINY = dict(model="stargan_v2", image_dim=32, base_dim=8, max_conv_dim=32, mapping_dim=32, style_dim=16,
            latent_dim=8, num_domains=3, batch_size=4, compute_dtype="float32", use_s2d=False, leaky_alpha=ALPHA,
            device_data=True)
# (C, H) of the generator's norms at AFHQ 256² (base width 64, widths up to 512)
SHAPES = [(64, 256), (64, 128), (128, 128), (128, 64), (256, 64), (256, 32), (512, 32), (512, 16)]
# (C, H) of the biased convs' outputs of G, E and D at AFHQ 256²: to_rgb's and D's logits are 3 wide
EPILOGUE_SHAPES = [(3, 256), (64, 256), (128, 128), (256, 64), (512, 32), (512, 16), (512, 8), (512, 4),
                   (512, 1), (3, 1)]


def _affine(kind: str, b: int, c: int, gen, device="cpu"):
    """(scale, shift, offset): IN's shared (C,) weight and bias, or AdaIN's
    per-sample gamma and beta, halves of one (B, 2C) row as the model's."""
    if kind == "instance":
        return (torch.rand(c, generator=gen) + 0.5).to(device), torch.randn(c, generator=gen).to(device), 0.0
    gamma, beta = (torch.randn((b, 2 * c), generator=gen) * 0.5).to(device).chunk(2, 1)
    return gamma, beta, 1.0


def instance_norm_affine(x, scale, shift, eps: float = 1e-5):
    """``F.instance_norm`` of an NCHW x, then ``scale * x + shift``: each
    (C,) (shared by the samples) or (B, C) (one per sample)."""
    return F.instance_norm(x, eps=eps) * scale[..., None, None] + shift[..., None, None]


def _composition(x, scale, shift, offset):
    """The library's route: ``F.instance_norm`` and the affine, then LeakyReLU."""
    return F.leaky_relu(instance_norm_affine(x, offset + scale, shift), ALPHA)


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# The CPU: the plain version, the wrappers, the model


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("shape", [(3, 5, 6, 6), (2, 16, 8, 4)])
@pytest.mark.parametrize("kind", ["instance", "adain"])
def test_plain_equals_the_batch_norm_composition(kind, shape, layout):
    """Values and the gradients of x, scale and shift, in float32: the same
    arithmetic up to the order of the reductions."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    if layout == "channels_last":
        x = x.contiguous(memory_format=CL)
    dy = torch.randn(shape, generator=gen)
    scale, shift, offset = _affine(kind, shape[0], shape[1], gen)
    got_in = [t.clone().requires_grad_(True) for t in (x, scale, shift)]
    want_in = [t.clone().requires_grad_(True) for t in (x, scale, shift)]
    got = cn.channel_norm_lrelu(got_in[0], got_in[1], got_in[2], ALPHA, offset=offset)
    want = _composition(*want_in, offset)
    assert got.is_contiguous(memory_format=CL) == (layout == "channels_last")
    # measured under 1e-6 (the composition's instance_norm takes Welford moments)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    gg = torch.autograd.grad(got, got_in, dy)
    gw = torch.autograd.grad(want, want_in, dy)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def test_plain_moments_of_a_mean_far_from_its_spread():
    """A mean 100 times the spread: the plain moments against float64."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 16, 16), generator=gen) + 100.0
    y, mean, rstd = cn.channel_norm_lrelu_plain(x, torch.ones(8), torch.zeros(8), 0.0, ALPHA, 1e-5)
    xd = x.double()
    want = torch.rsqrt(xd.var((2, 3), unbiased=False) + 1e-5)
    assert _max_rel(rstd, want) < 1e-4 and _max_rel(mean, xd.mean((2, 3))) < 1e-6
    z = (xd - xd.mean((2, 3), keepdim=True)) * want[:, :, None, None]
    assert _max_rel(y, torch.where(z > 0, z, ALPHA * z)) < 1e-4


def test_double_backward_raises():
    """G's norms are never differentiated twice (R1 runs through D): the
    Function refuses a gradient of its gradient."""
    x = torch.randn((2, 4, 5, 5), requires_grad=True)
    y = cn.channel_norm_lrelu(x, torch.ones(4), torch.zeros(4), ALPHA)
    with pytest.raises(RuntimeError, match="first order only"):
        torch.autograd.grad(y.square().sum(), x, create_graph=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h", SHAPES)
def test_plan_covers_every_pixel(c, h, dtype):
    """Each split takes ``chunk`` pixels, the last one the rest; a launch has
    about 8 blocks an SM of the H100's 132, each reading 2 rows or more a thread."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    p = h * h
    splits, chunk = cn.plan(8, c, p, vec, 132)
    assert (splits - 1) * chunk < p <= splits * chunk
    rows = 256 // (64 // vec)
    assert chunk >= min(p, 2 * rows) and splits * (c // 64) * 8 <= 2 * 8 * 132


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn((2, 8, 4, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cn._check(x.to("meta"), "f")
    xc = x.contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="float32"):
        cn._affine(torch.ones(8, dtype=torch.bfloat16), torch.zeros(8), xc, "f")
    with pytest.raises(ValueError, match="differ"):
        cn._affine(torch.ones(8), torch.zeros((2, 8)), xc, "f")
    h = torch.randn((2, 16))
    scale, shift, sb = cn._affine(*h.chunk(2, 1), xc, "f")
    assert sb == 16 and scale.data_ptr() == h.data_ptr()  # AdaIN's halves pass as they lie
    assert cn._affine(torch.ones(8), torch.zeros(8), xc, "f")[2] == 0
    assert cn._vec(xc) == 4 and cn._vec(xc.to(torch.bfloat16)) == 8
    assert cn._vec(torch.randn((2, 6, 4, 4)).contiguous(memory_format=CL)) == 1


@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_resample_plain_equals_pool_and_interpolate(up, layout):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 5, 6, 4), generator=gen)
    if layout == "channels_last":
        x = x.contiguous(memory_format=CL)
    got = rs.Up2.apply(x, 1.0) if up else rs.Down2.apply(x, 0.25)
    want = F.interpolate(x, scale_factor=2, mode="nearest") if up else F.avg_pool2d(x, 2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert got.is_contiguous(memory_format=CL) == (layout == "channels_last")


@pytest.mark.parametrize("s", [0.25, 1.0])
def test_resample_functions_are_each_others_adjoint(s):
    """Down2's backward is Up2 and Up2's Down2: first and second derivatives
    against finite differences in float64."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, 4, 6), generator=gen, dtype=torch.float64, requires_grad=True)
    for fn in (rs.Down2.apply, rs.Up2.apply):
        assert torch.autograd.gradcheck(lambda t: fn(t, s).square(), (x,))
        assert torch.autograd.gradgradcheck(lambda t: fn(t, s).square(), (x,))


def _tiny_cfg(**kw) -> Config:
    return Config(**{**TINY, **kw})


def _nchw_path(monkeypatch):
    """The NCHW path: contiguous weights and activations, the norms through
    ``F.instance_norm``, the affine and ``F.leaky_relu``."""
    monkeypatch.setattr(sm, "LAYOUT", torch.contiguous_format)
    monkeypatch.setattr(sm, "channel_norm_lrelu", lambda x, scale, shift, alpha, offset=0.0, eps=1e-5:
                        F.leaky_relu(instance_norm_affine(x, offset + scale, shift, eps), alpha))


def _network_case(net: str, model, x, s, z, y):
    """(outputs, the parameters differentiated) of one network, or of R1 (D's penalty)."""
    if net == "generator":
        return model.generator(x, s), model.generator
    if net == "mapping_network":
        return model.mapping_network(z, y), model.mapping_network
    if net == "style_encoder":
        return model.style_encoder(x, y), model.style_encoder
    xr = x.detach().requires_grad_(True)
    out = model.discriminator(xr, y)
    if net == "discriminator":
        return out, model.discriminator
    return ts.r1_reg(out, xr).reshape(1), model.discriminator


@pytest.mark.parametrize("net", ["generator", "mapping_network", "style_encoder", "discriminator", "r1"])
def test_channels_last_model_equals_the_nchw_path(net, monkeypatch):
    """The same weights and inputs through the channels-last model and
    through today's NCHW path: outputs and every parameter gradient agree
    (float32; the convolutions' algorithms and the norms' reductions differ
    by order only)."""
    cfg = _tiny_cfg()
    gen = torch.Generator().manual_seed(9)
    model = sm.init_params(sm.StarGANv2(cfg), 4)
    x = torch.rand((4, 3, 32, 32), generator=gen) * 2 - 1
    s, z = torch.randn((4, 16), generator=gen), torch.randn((4, 8), generator=gen)
    y = torch.tensor([0, 2, 1, 2])
    with monkeypatch.context() as m:
        _nchw_path(m)
        old = sm.StarGANv2(cfg)
        old.load_state_dict(model.state_dict())
        assert all(p.is_contiguous() for p in old.parameters())
        want, want_net = _network_case(net, old, x, s, z, y)
        w_params = list(want_net.parameters())
        w_grads = torch.autograd.grad(want, w_params, torch.ones_like(want), allow_unused=True)
    got, got_net = _network_case(net, model, x, s, z, y)
    g_params = list(got_net.parameters())
    g_grads = torch.autograd.grad(got, g_params, torch.ones_like(got), allow_unused=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    names = [n for n, _ in got_net.named_parameters()]
    med = float(np.median([float(b.norm()) for b in w_grads if b is not None]))
    for name, p, a, b in zip(names, g_params, g_grads, w_grads):
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=CL) and a.is_contiguous(memory_format=CL), name
        if float(b.norm()) < 1e-3 * med:
            # a bias ahead of an instance norm: its gradient is rounding noise in both
            assert float(a.norm()) < 1e-3 * med, name
            continue
        # a live gradient agrees to 0.1% of its norm (measured under 1e-4)
        assert float((a - b).norm()) <= 1e-3 * float(b.norm()), name


def test_every_conv_reads_and_writes_channels_last():
    """A generator pass and its backward at a tiny size: every conv's input,
    output and weight, and every norm's input and output, lie channels-last."""
    cfg = _tiny_cfg()
    model = sm.init_params(sm.StarGANv2(cfg), 5)
    seen = []

    def hook(mod, args, out):
        seen.append((type(mod).__name__, [t for t in (*args, out) if torch.is_tensor(t) and t.dim() == 4]))

    for mod in model.generator.modules():
        if isinstance(mod, (sm.Conv, sm.InstanceNorm)):
            mod.register_forward_hook(hook)
    out = model.generator(torch.rand((4, 3, 32, 32)), torch.randn((4, 16)))
    assert len(seen) > 20
    for name, ts_ in seen:
        assert all(t.is_contiguous(memory_format=CL) for t in ts_), name
    grads = torch.autograd.grad(out.sum(), list(model.generator.parameters()))
    for (name, p), g in zip(model.generator.named_parameters(), grads):
        assert g.stride() == p.stride(), name  # so Adam's foreach kernels take their fast route


def test_norm_counters_per_generator_pass():
    """2 norms a ResBlk and an AdainResBlk and to_rgb's: 13 a pass at 32²
    (a downsampling block, two bottleneck ones), 25 at 256²; a backward pass
    as many."""
    cfg = _tiny_cfg()
    model = sm.init_params(sm.StarGANv2(cfg), 5)
    g = model.generator
    assert 2 * (len(g.encode) + len(g.decode)) + 1 == 13
    assert 2 * 2 * (int(np.log2(256)) - 4 + 2) + 1 == 25
    before = _build.launch_counts()
    out = g(torch.rand((4, 3, 32, 32)), torch.randn((4, 16)))
    mid = _build.launch_counts()
    torch.autograd.grad(out.sum(), list(g.parameters()))
    after = _build.launch_counts()
    key, bwd = "stargan_v2.channel_norm", "stargan_v2.channel_norm_bwd"
    assert (mid[key] - before.get(key, 0), mid[bwd] - before.get(bwd, 0)) == (13, 0)
    assert (after[key] - mid[key], after[bwd] - mid[bwd]) == (0, 13)


def test_kernel_counters_per_iteration_at_256():
    """One eager iteration at the benchmark's depth (256², so 4 downsampling
    blocks in G and 6 in E and D) with narrow widths: the counts the card
    smoke requires of the full-width iteration (``chip_smoke.py``'s
    ``SG_EXPECTED_CALLS``). 25 norms in each of the 8 generator passes, 4
    of them differentiated; the pools and upsamples of every pass, their
    backwards and R1's double backward through D. The epilogue: 26 / 14 /
    15 biased convs a G / E / D pass, so 8 * 26 + 7 * 14 + 6 * 15 = 396 in
    the passes, and 12 more in R1's double backward (the 1/sqrt(2) of D's
    six residual blocks, each D phase); its backward in the 4 G, 3 E and 8
    D passes gradients run through (R1's first backward among them): 4 * 26
    + 3 * 14 + 8 * 15 = 266."""
    from littlegan_tpu_torch.data.domains import BalancedSampler

    cfg = _tiny_cfg(image_dim=256, base_dim=4, mapping_dim=16, style_dim=8, latent_dim=4, batch_size=2)
    state = create_stargan_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8, generator=gen)
    domains = np.arange(8) % 3
    ids = np.stack([BalancedSampler(domains, 3).draw(np.random.default_rng(2), 2)])
    heights = set()
    plain = cn.channel_norm_lrelu_plain

    def spy(x, *args):
        heights.add(x.shape[2])
        return plain(x, *args)

    keys = ("stargan_v2.channel_norm", "stargan_v2.channel_norm_bwd", "stargan_v2.down2", "stargan_v2.up2",
            "stargan_v2.conv_epilogue", "stargan_v2.conv_epilogue_bwd")
    before = _build.launch_counts()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cn, "channel_norm_lrelu_plain", spy)
        losses = ts.eager_iterations(state, cfg, images, torch.as_tensor(domains), ids,
                                     ts.stack_draws([ts.draw_iteration(gen, cfg, "cpu")]), 0)
    after = _build.launch_counts()
    assert bool(torch.isfinite(losses).all())
    assert [after[k] - before.get(k, 0) for k in keys] == [200, 100, 276, 228, 408, 266]
    assert heights == {256, 128, 64, 32, 16}


def test_state_dict_keys_keep_the_published_names():
    """The fused norm keeps ``to_rgb.0`` and ``to_rgb.2`` (the published
    Sequential's IN and conv), and a state round-trips with its values."""
    cfg = _tiny_cfg(ema_decay=0.9)
    model = sm.init_params(sm.StarGANv2(cfg), 6)
    keys = list(model.state_dict())
    assert "generator.to_rgb.0.weight" in keys and "generator.to_rgb.2.weight" in keys
    assert not any(k.startswith("generator.to_rgb.1") for k in keys)
    state = create_stargan_state(cfg, "cpu", model)
    for opt in state.OPTS:
        adam = getattr(state, opt)
        for k, p in dict(model.named_parameters()).items():
            if k in adam.mu:
                assert adam.mu[k].stride() == p.stride() == adam.nu[k].stride(), k
    for k, e in state.ema.items():
        assert e.stride() == dict(model.named_parameters())[k].stride(), k


class _ParentR1Conv(torch.autograd.Function):
    """The parent's ``_R1Conv``: the bias inside ``F.conv2d``, its gradient
    ``g.sum((0, 2, 3))``."""

    @staticmethod
    def forward(ctx, x, w, b, padding):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.has_bias = padding, b is not None
        return F.conv2d(x, w, b, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.padding
        gw = torch.ops.aten.convolution_backward(g, x, w, None, [1, 1], [p, p], [1, 1], False, [0, 0], 1,
                                                 [False, True, False])[1]
        return F.conv_transpose2d(g, w, padding=p), gw, g.sum((0, 2, 3)) if ctx.has_bias else None, None


def _parent_path(monkeypatch):
    """The parent's arithmetic: each conv's bias inside the convolution (in
    the input's dtype), a residual block's ``(sc + r) / sqrt(2)`` after it."""

    def out(r, sc, s):
        if sc is None:
            return r
        assert s == 1.0 / sm.SQRT2
        return (sc + r) / sm.SQRT2

    def conv(self, x, sc=None, s=1.0):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return out(F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding), sc, s)

    def r1_conv(self, x, sc=None, s=1.0):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return out(_ParentR1Conv.apply(x, self.weight.to(x.dtype), b, self.padding[0]), sc, s)

    monkeypatch.setattr(sm.Conv, "forward", conv)
    monkeypatch.setattr(sm.R1Conv, "forward", r1_conv)


@pytest.mark.parametrize("net", ["generator", "style_encoder", "discriminator", "r1"])
def test_epilogue_route_equals_the_parent_arithmetic(net, monkeypatch):
    """The same weights (biases drawn N(0, 0.1), so that each is added) and
    inputs through the model's plain route and through the parent's
    arithmetic, float32: the outputs within 1e-6 of their norm, every
    parameter gradient within 1e-6 of its norm, or of the network's median
    gradient norm where that is larger (a bias ahead of an instance norm
    has a gradient of rounding noise in both). The two differ by a rounding
    per conv (1/sqrt(2) multiplied in place of a division, the bias added
    after the convolution's sum in place of inside it, a bias gradient
    summed before the 1/sqrt(2) in place of after it). Measured over six
    seeds, one thread: D's and R1's gradients under 4.7e-7; E's bias
    gradients, sums of a thousand terms that cancel, up to 2.1e-6; G's
    thirteen instance norms carry the roundings into its gradients at up to
    4.9e-6. So E's are held to 5e-6 and G's to 1e-5."""
    cfg = _tiny_cfg()
    gen = torch.Generator().manual_seed(9)
    model = sm.init_params(sm.StarGANv2(cfg), 4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, 0.1, generator=gen)
    x = torch.rand((4, 3, 32, 32), generator=gen) * 2 - 1
    s, z = torch.randn((4, 16), generator=gen), torch.randn((4, 8), generator=gen)
    y = torch.tensor([0, 2, 1, 2])
    with monkeypatch.context() as m:
        _parent_path(m)
        want, want_net = _network_case(net, model, x, s, z, y)
        w_grads = torch.autograd.grad(want, list(want_net.parameters()), torch.ones_like(want), allow_unused=True)
    before = _build.launch_counts()["stargan_v2.conv_epilogue"]
    got, got_net = _network_case(net, model, x, s, z, y)
    assert _build.launch_counts()["stargan_v2.conv_epilogue"] > before
    g_grads = torch.autograd.grad(got, list(got_net.parameters()), torch.ones_like(got), allow_unused=True)
    assert float((got - want).detach().norm()) <= 1e-6 * float(want.detach().norm())
    med = float(np.median([float(b.norm()) for b in w_grads if b is not None]))
    tol = {"generator": 1e-5, "style_encoder": 5e-6}.get(net, 1e-6)
    for (name, _), a, b in zip(got_net.named_parameters(), g_grads, w_grads):
        assert (a is None) == (b is None), name
        if a is not None:
            assert float((a - b).norm()) <= tol * max(float(b.norm()), med), name


_EPILOGUE_FORMS = {"bias": (True, False, 1.0), "residual": (True, True, 1.0 / math.sqrt(2.0)),
                   "scale": (False, False, 1.0 / math.sqrt(2.0))}


@pytest.mark.parametrize("c", [3, 8])
@pytest.mark.parametrize("form", list(_EPILOGUE_FORMS))
def test_epilogue_functions_differentiate_to_any_order(form, c):
    """The epilogue (``s * (y + b + sc)``: bias only, the residual form at
    1/sqrt(2), the scale alone that a double backward calls) and its
    backward Function, first and second derivatives against finite
    differences in float64; the backward's own backward is the epilogue."""
    has_b, has_sc, s = _EPILOGUE_FORMS[form]
    gen = torch.Generator().manual_seed(c)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64).requires_grad_(True)

    y, g = rand(2, c, 3, 4), rand(2, c, 3, 4)
    b, sc = (rand(c) if has_b else None), (rand(2, c, 3, 4) if has_sc else None)
    inputs = tuple(t for t in (y, b, sc) if t is not None)

    def fwd(*ts):
        it = iter(ts)
        return ce.conv_epilogue(next(it), next(it) if has_b else None, next(it) if has_sc else None, s)

    assert torch.autograd.gradcheck(fwd, inputs) and torch.autograd.gradgradcheck(fwd, inputs)
    bwd = lambda t: ce.EpilogueBwd.apply(t, s)  # noqa: E731
    assert torch.autograd.gradcheck(bwd, (g,)) and torch.autograd.gradgradcheck(bwd, (g,))
    want = (y + (b[:, None, None] if has_b else 0) + (sc if has_sc else 0)) * s
    torch.testing.assert_close(fwd(*inputs), want, rtol=1e-12, atol=1e-12)
    gs, db = bwd(g)
    torch.testing.assert_close(gs, g * s, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, g.sum((0, 2, 3)) * s, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("net,calls,residual", [("generator", 14, 6), ("style_encoder", 8, 3), ("discriminator", 9, 3),
                                                ("r1", 9, 3)])
def test_epilogue_calls_per_network_pass(net, calls, residual):
    """At 32² (1 downsampling and 2 bottleneck blocks in G, 3 downsampling
    blocks in E and D): every biased conv of a pass calls the epilogue once,
    a residual block's second conv with its shortcut; its backward once
    each. R1 (D's first backward with a graph, then its double backward)
    adds one forward call per residual block, the 1/sqrt(2) of the
    adjoint."""
    cfg = _tiny_cfg()
    model = sm.init_params(sm.StarGANv2(cfg), 3)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((4, 3, 32, 32), generator=gen) * 2 - 1
    s, z, y = torch.randn((4, 16), generator=gen), torch.randn((4, 8), generator=gen), torch.tensor([0, 2, 1, 2])
    seen = []
    plain = ce.conv_epilogue_plain

    def spy(y_, b, sc, s_):
        seen.append(sc is not None)
        return plain(y_, b, sc, s_)

    keys = ("stargan_v2.conv_epilogue", "stargan_v2.conv_epilogue_bwd")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ce, "conv_epilogue_plain", spy)
        before = _build.launch_counts()
        out, net_ = _network_case(net, model, x, s, z, y)
        mid = _build.launch_counts()
        assert (len(seen), sum(seen)) == (calls, residual)
        torch.autograd.grad(out, list(net_.parameters()), torch.ones_like(out), allow_unused=True)
        after = _build.launch_counts()
    r1 = net == "r1"
    assert [mid[k] - before[k] for k in keys] == [calls, calls if r1 else 0]
    assert [after[k] - mid[k] for k in keys] == [residual if r1 else 0, 0 if r1 else calls]


def test_epilogue_shapes_at_full_width():
    """The (C, H) of every biased conv's output in G, E and D at the
    benchmark's configuration (run on the meta device, plain versions):
    ``EPILOGUE_SHAPES``, which the card tests run the kernels at; a residual
    form at each map of 4² to 256² but for the 3 channels of to_rgb and the
    512 of the 4x4 conv's output."""
    cfg = _cell_cfg()
    with torch.device("meta"):
        model = sm.StarGANv2(cfg)
    seen = set()
    plain = ce.conv_epilogue_plain

    def spy(y, b, sc, s):
        seen.add((y.shape[1], y.shape[2], sc is not None))
        return plain(y, b, sc, s)

    x = torch.empty((2, 3, 256, 256), device="meta")
    y = torch.zeros(2, dtype=torch.long, device="meta")
    with pytest.MonkeyPatch.context() as m, _build.plain_versions():
        m.setattr(ce, "conv_epilogue_plain", spy)
        model.generator(x, torch.empty((2, cfg.style_dim), device="meta"))
        model.style_encoder(x, y)
        model.discriminator(x, y)
    assert {(c, h) for c, h, _ in seen} == set(EPILOGUE_SHAPES)
    assert {(c, h) for c, h, res in seen if res} == {(64, 256), (128, 128), (256, 64), (512, 32), (512, 16),
                                                     (512, 8), (512, 4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h", EPILOGUE_SHAPES)
def test_epilogue_plan_covers_every_row(c, h, dtype):
    """The backward's column sum at batch 8 on the H100's 132 SMs: each
    split takes ``chunk`` rows, the last the rest; a launch has at most 4
    blocks an SM, each thread adding 4 rows or more, so that a map of 4
    rows a thread or fewer (bf16 at 4² and below) takes one split, one
    launch."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size() if c % 8 == 0 else 1
    rows = 8 * h * h
    splits, chunk = ce.plan(rows, c, vec, 132)
    assert (splits - 1) * chunk < rows <= splits * chunk
    per_pass = 256 // -(-min(64, c) // vec)
    assert splits * -(-c // 64) <= 4 * 132 + -(-c // 64)
    assert splits == 1 or chunk >= 4 * per_pass
    if rows <= 4 * per_pass:
        assert splits == 1
    if dtype == torch.bfloat16 and h <= 4:
        assert splits == 1


def test_epilogue_wrappers_refuse_what_the_kernels_do_not_take():
    y = torch.randn((2, 8, 4, 4)).contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ce.conv_epilogue_fwd(y.to("meta"), None, None, 1.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ce.conv_epilogue_bwd(y.to("meta"), 1.0)
    assert ce._vec(y) and ce._vec(y.to(torch.bfloat16))
    assert not ce._vec(torch.randn((2, 12, 4, 4)).to(torch.bfloat16).contiguous(memory_format=CL))
    assert not ce._vec(torch.randn((2, 3, 4, 4)).contiguous(memory_format=CL))
    assert not ce._vec(y, torch.randn(9)[1:])  # a pointer off 16 bytes


# ---------------------------------------------------------------------------
# The card


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_case(c, h, dtype, kind, card, seed, mean=0.0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((8, c, h, h), generator=gen) + mean).to(card, dtype).contiguous(memory_format=CL)
    dy = torch.randn((8, c, h, h), generator=gen).to(card, dtype).contiguous(memory_format=CL)
    scale, shift, offset = _affine(kind, 8, c, gen, card)
    return x, dy, scale, shift, offset


def _bwd_f64(x, dy, scale, shift, offset, mean, rstd, positive):
    """(dx, dscale, dshift) in float64 from the given moments, with the
    LeakyReLU's side of each element given (``positive``)."""
    b, p = x.shape[0], x.shape[2] * x.shape[3]
    r = rstd.double()[:, :, None, None]
    d = x.double() - mean.double()[:, :, None, None]
    a = (offset + scale.double().expand(b, -1))[:, :, None, None] * r
    g = dy.double()
    dz = torch.where(positive, g, ALPHA * g)
    n = d * r
    dshift, dscale = dz.sum((2, 3)), (dz * n).sum((2, 3))
    return a * (dz - dshift[:, :, None, None] / p - n * dscale[:, :, None, None] / p), dscale, dshift


@pytest.mark.card
@pytest.mark.parametrize("kind", ["instance", "adain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h", SHAPES)
def test_kernels_equal_the_plain_version(card, c, h, dtype, kind):
    """The forward at the generator's shapes against the plain version on
    the same tensors: y within one rounding of x's dtype (both round an f32
    value once; the f32 values differ in the reductions' order), the moments
    to f32 rounding. The LeakyReLU's side of an element differs from the
    plain version's only where z is 0 to rounding (the kernel's z is one
    fused multiply-add): the backward against float64 from the kernel's
    moments and sides, dx within one rounding, dscale and dshift to f32
    rounding."""
    x, dy, scale, shift, offset = _card_case(c, h, dtype, kind, card, c + h)
    y, mean, rstd = cn.channel_norm_lrelu_fwd(x, scale, shift, offset, ALPHA, 1e-5)
    dx, ds, dh = cn.channel_norm_lrelu_bwd(x, dy, scale, shift, offset, mean, rstd, ALPHA)
    yp, mp, rp = cn.channel_norm_lrelu_plain(x, scale, shift, offset, ALPHA, 1e-5)
    torch.cuda.synchronize(card)
    assert y.is_contiguous(memory_format=CL) and dx.is_contiguous(memory_format=CL)
    pos = y > 0
    flips = pos != (yp > 0)
    z = (x.double() - mp.double()[:, :, None, None]) * (
        (offset + scale.double().expand(8, -1)) * rp.double())[:, :, None, None] + shift.double().expand(8, -1)[
        :, :, None, None]
    kink = float(z[flips].abs().max() / z.abs().max()) if bool(flips.any()) else 0.0
    dxw, dsw, dhw = _bwd_f64(x, dy, scale, shift, offset, mean, rstd, pos)
    out_tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    errs = {"y": _max_rel(y, yp), "dx": _max_rel(dx, dxw), "mean": _max_rel(mean, mp), "rstd": _max_rel(rstd, rp),
            "dscale": _max_rel(ds, dsw), "dshift": _max_rel(dh, dhw)}
    print(f"(C, H) = ({c}, {h}) {dtype} {kind}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; {int(flips.sum())} sides differ, |z| there <= {kink:.1e} of the largest")
    assert kink < 1e-5
    assert errs["y"] <= out_tol and errs["dx"] <= out_tol
    assert max(errs["mean"], errs["rstd"], errs["dscale"], errs["dshift"]) < 1e-4


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("c,h", [(64, 256), (128, 128), (256, 64), (512, 32), (512, 16), (512, 8), (6, 32)])
def test_resample_kernel_equals_the_plain_version(card, c, h, up, dtype):
    """The pool and the upsample (and each one's backward, the other at the
    same scale) at StarGAN v2's shapes, batch 8, and at 6 channels (one
    element a thread): the upsample bit for bit, the pool within one
    rounding of x's dtype (the same f32 sum in another order)."""
    gen = torch.Generator().manual_seed(c + h)
    x = torch.randn((8, c, h, h), generator=gen).to(card, dtype).contiguous(memory_format=CL)
    for s in (0.25, 1.0):
        got, want = rs.resample2(x, s, up), rs.resample2_plain(x, s, up)
        assert got.is_contiguous(memory_format=CL) and got.shape == want.shape
        if up:
            assert torch.equal(got, want)
        else:
            assert _max_rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-6)
    xc = x.contiguous()  # copied to channels-last first
    assert torch.equal(rs.resample2(xc, 1.0, up), rs.resample2(x, 1.0, up))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_moments_of_a_mean_far_from_its_spread(card, dtype):
    """x = 100 + N(0, 1): the kernel's shifted sums against float64 moments
    of the same values (E[x^2] - mean^2 would cancel to noise here)."""
    x, dy, scale, shift, offset = _card_case(64, 128, dtype, "adain", card, 1, mean=100.0)
    y, mean, rstd = cn.channel_norm_lrelu_fwd(x, scale, shift, offset, ALPHA, 1e-5)
    xd = x.double()
    want = torch.rsqrt(xd.var((2, 3), unbiased=False) + 1e-5)
    assert _max_rel(rstd, want) < 1e-4 and _max_rel(mean, xd.mean((2, 3))) < 1e-6
    yp, _, _ = cn.channel_norm_lrelu_plain(x, scale, shift, offset, ALPHA, 1e-5)
    assert _max_rel(y, yp) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.card
def test_kernel_refuses_a_map_that_is_not_channels_last(card):
    """On the card the norm reads NHWC or raises: no copy, no fallback."""
    x, dy, scale, shift, offset = _card_case(64, 16, torch.bfloat16, "instance", card, 2)
    with pytest.raises(ValueError, match="channels-last"):
        cn.channel_norm_lrelu(x.contiguous(), scale, shift, ALPHA)


@pytest.mark.card
def test_graph_replays_equal_eager_bit_for_bit(card):
    """The Function's forward and backward captured in a CUDA graph: each
    replay equals the eager call bit for bit (fixed-order sums)."""
    x, dy, scale, shift, offset = _card_case(128, 64, torch.bfloat16, "adain", card, 5)

    def run():
        xi, si, hi = (t.detach().requires_grad_(True) for t in (x, scale, shift))
        out = cn.channel_norm_lrelu(xi, si, hi, ALPHA, offset=offset)
        return (out, *torch.autograd.grad(out, (xi, si, hi), dy))

    eager = run()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize(card)
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def _epilogue_case(c, h, dtype, card, seed, residual):
    """(y, b, sc, g, s) at batch 8: the residual form (sc, 1/sqrt(2)) or the bias alone."""
    gen = torch.Generator().manual_seed(seed)

    def rand():
        return torch.randn((8, c, h, h), generator=gen).to(card, dtype).contiguous(memory_format=CL)

    y, g = rand(), rand()
    sc = rand() if residual else None
    b = torch.randn(c, generator=gen).to(card)
    return y, b, sc, g, (1.0 / math.sqrt(2.0) if residual else 1.0)


@pytest.mark.card
@pytest.mark.parametrize("form", ["bias", "residual"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h", EPILOGUE_SHAPES)
def test_epilogue_kernels_equal_the_plain_version(card, c, h, dtype, form):
    """The forward and the backward at the (C, H) of every biased conv of
    the cell's iteration (16-byte vectors, and one element a thread at 3
    channels), batch 8: the output within one rounding of x's dtype of the
    plain version's (both round one f32 value; printed whether equal), s g
    equal to it; db within 1e-5 of float64's column sum, the same bits in
    two calls."""
    y, b, sc, g, s = _epilogue_case(c, h, dtype, card, c + h, form == "residual")
    out, want = ce.conv_epilogue_fwd(y, b, sc, s), ce.conv_epilogue_plain(y, b, sc, s)
    (gs, db), (gs2, db2) = ce.conv_epilogue_bwd(g, s), ce.conv_epilogue_bwd(g, s)
    gsp, _ = ce.conv_epilogue_bwd_plain(g, s)
    db64 = g.double().sum((0, 2, 3)) * s
    torch.cuda.synchronize(card)
    assert out.is_contiguous(memory_format=CL) and gs.is_contiguous(memory_format=CL)
    assert (gs is g) == (s == 1.0) and torch.equal(gs, gsp)
    errs = {"out": _max_rel(out, want), "db": _max_rel(db, db64)}
    print(f"(C, H) = ({c}, {h}) {dtype} {form}: out {errs['out']:.2e} (equal {torch.equal(out, want)}), "
          f"db {errs['db']:.2e}, splits {ce.plan(8 * h * h, c, 16 // y.element_size() if c % 8 == 0 else 1, 132)}")
    assert errs["out"] <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-6)
    assert db.dtype == torch.float32 and errs["db"] <= 1e-5 and torch.equal(db, db2)


@pytest.mark.card
def test_epilogue_refuses_a_map_that_is_not_channels_last(card):
    """On the card the epilogue reads NHWC y and sc or raises: no copy, no fallback."""
    y, b, sc, g, s = _epilogue_case(64, 16, torch.bfloat16, card, 3, True)
    with pytest.raises(ValueError, match="channels-last"):
        ce.conv_epilogue(y.contiguous(), b)
    with pytest.raises(ValueError, match="channels-last"):
        ce.conv_epilogue(y, b, sc.contiguous(), s)


@pytest.mark.card
def test_epilogue_graph_replays_equal_eager_bit_for_bit(card):
    """The residual epilogue, its backward and its double backward (as R1
    runs it) captured in a CUDA graph: each replay equals the eager call bit
    for bit (fixed-order column sums)."""
    y, b, sc, g, s = _epilogue_case(128, 64, torch.bfloat16, card, 5, True)

    def run():
        yi, bi, si, gi = (t.detach().requires_grad_(True) for t in (y, b, sc, g))
        out = ce.conv_epilogue(yi, bi, si, s)
        gy, gb = torch.autograd.grad(out, (yi, bi), gi, create_graph=True)
        (ggi,) = torch.autograd.grad(gy.float().square().sum() + gb.square().sum(), gi)
        return out, gy, gb, ggi

    eager = run()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize(card)
        assert all(torch.equal(a, e) for a, e in zip(captured, eager))


def _cell_cfg() -> Config:
    with open(os.path.join(ROOT, "benchmark", "configs", "stargan-v2-afhq-256.json")) as f:
        d = json.load(f)
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in names}).replace(device_data=True)


def _conv_of(op: dict) -> str:
    dims = op.get("args", {}).get("Input Dims") or []
    return f"{op['name']} {[d for d in dims if d][:3]}"


def _three_channel_or_4x4(op: dict) -> bool:
    """A conv op with a 3-channel input, output or weight side, or a 4x4 kernel."""
    dims = [d for d in (op.get("args", {}).get("Input Dims") or []) if isinstance(d, list) and len(d) == 4]
    return any(3 in d[:2] for d in dims) or any(d[2:] == [4, 4] for d in dims)


@pytest.mark.card
def test_stargan_iteration_is_channels_last_on_the_card(card, tmp_path):
    """One eager iteration of the benchmark's configuration (AFHQ 256²,
    batch 8, bf16) under the profiler, after one that meets every first use:
    cuDNN's layout transposes only around the 3-channel and 4x4 convs,
    listed with their ms; the norm counters at 200 forward and 100 backward,
    the epilogue's at 408 and 266, and no ``aten::sum`` over a 4-D map (the
    bias gradients are the epilogue's); Adam's updates in
    ``multi_tensor_apply`` kernels."""
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.data.domains import BalancedSampler

    cfg = _cell_cfg()
    state = create_stargan_state(cfg, card)
    gen = torch.Generator(device=card).manual_seed(1)
    images = torch.randint(0, 256, (64, 256, 256, 3), dtype=torch.uint8, device=card, generator=gen)
    labels = (torch.arange(64) % 3).to(card)
    sampler, rng = BalancedSampler((np.arange(64) % 3), 3), np.random.default_rng(2)
    dgen = torch.Generator(device=card).manual_seed(3)

    def one(it):
        ids = np.stack([sampler.draw(rng, 8)])
        draws = ts.stack_draws([ts.draw_iteration(dgen, cfg, card)])
        return ts.eager_iterations(state, cfg, images, labels, ids, draws, it)

    one(0)
    torch.cuda.synchronize(card)
    before = _build.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        losses = one(1)
        torch.cuda.synchronize(card)
    after = _build.launch_counts()
    assert bool(torch.isfinite(losses).all())
    want = {"stargan_v2.channel_norm": 200, "stargan_v2.channel_norm_bwd": 100, "stargan_v2.conv_epilogue": 408,
            "stargan_v2.conv_epilogue_bwd": 266}
    counts = {k: after[k] - before.get(k, 0) for k in want}
    assert counts == want, counts

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and "conv" in e["name"]),
                 key=lambda e: e["dur"])  # the innermost conv op first

    def op_of(kernel):
        la = launch.get(kernel["args"].get("correlation"))
        if la is None:
            return None
        return next((o for o in ops if o["tid"] == la["tid"] and o["ts"] <= la["ts"] <= o["ts"] + o["dur"]), None)

    transposes = [k for k in kernels if re.search(r"nchwToNhwc|nhwcToNchw", k["name"])]
    where, stray = {}, []
    for k in transposes:
        op = op_of(k)
        key = _conv_of(op) if op is not None else "no conv op"
        where[key] = where.get(key, 0.0) + k["dur"] / 1e3
        if op is None or not _three_channel_or_4x4(op):
            stray.append((k["name"][:60], key))
    print(f"layout transposes: {len(transposes)} kernels, {sum(where.values()):.3f} ms")
    for key, ms in sorted(where.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:.3f} ms  {key}")
    assert not stray, stray[:10]
    norm_ms = sum(k["dur"] for k in kernels if "instance_norm" in k["name"]) / 1e3
    adam = [k for k in kernels if "multi_tensor_apply" in k["name"]]
    print(f"norm kernels {norm_ms:.3f} ms; multi_tensor_apply {len(adam)} kernels "
          f"{sum(k['dur'] for k in adam) / 1e3:.3f} ms; all kernels {sum(k['dur'] for k in kernels) / 1e3:.3f} ms")
    assert norm_ms > 0 and len(adam) >= 6
    # every conv bias gradient is the epilogue's column sum: no aten::sum over a map
    map_sums = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::sum"
                and len((e.get("args", {}).get("Input Dims") or [[]])[0]) == 4]
    assert not map_sums, [e["args"]["Input Dims"] for e in map_sums[:5]]
    for opt in state.OPTS:
        adam_state = getattr(state, opt)
        for name, p in state.model.named_parameters():
            if name in adam_state.mu:
                assert adam_state.mu[name].stride() == p.stride(), name
