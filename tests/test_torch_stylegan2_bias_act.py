"""S5, StyleGAN2's layer epilogue (``ops/cuda/bias_act.py``,
``csrc/bias_act.cu``): ``clamp(act(y * d + noise * noise_strength + b) *
gain', +-256 gain)`` in one pass, its backward from the gradient and the
saved y, and the backward's own backward. Imports no JAX.

On the CPU (the plain versions, through the autograd Functions), at
tiny-config sizes: the forward and every gradient, first and second order,
against the ops the model ran before S5 (``y * d``, the noise's add, S3's
bias, ``r1_leaky_relu``, the gain, ``clamp``) in float32, in four forms
(G's modulated layer with d and noise, D's conv at gain sqrt(1/2), ToRGB's
linear layer, the clamp engaged on both sides); ``gradcheck`` and
``gradgradcheck`` in float64; the Functions' calls (counted by wrapping
them: the counters count launches on the card alone); the backward's split
plan.

On a card (marked ``card``; skips without one): the kernels against their
plain versions at the StyleGAN2 iteration's shapes (C 3 to 512, 4² to
256², batch 8) in bf16 and float32, and the reductions bit for bit over two
calls. On the card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_stylegan2_bias_act.py -m card``.
"""

from __future__ import annotations

import collections
import math

import pytest
import torch

from littlegan_tpu_torch.models import stylegan2 as sm
from littlegan_tpu_torch.ops.cuda import bias_act as ba
from littlegan_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue
from littlegan_tpu_torch.ops.gradfix import r1_leaky_relu
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

CL = torch.channels_last

# (name, act, gain, demodulated with noise, y's scale): G's modulated layer, D's conv1 at gain sqrt(1/2),
# ToRGB (linear, C 3), and a map of std 1000 that the clamp of +-256 cuts on both sides (below -256 where
# 0.2 sqrt(2) pre is)
FORMS = [("g_layer", True, 1.0, True, 1.0), ("d_conv", True, math.sqrt(0.5), False, 1.0),
         ("to_rgb", False, 1.0, False, 1.0), ("clamped", True, 1.0, True, 1000.0)]
IDS = [f[0] for f in FORMS]


def inputs(form, dtype=torch.float32, n=3, c=5, h=6, seed=0, device="cpu"):
    """(y, d, noise, noise_strength, b) of one form, every float input needing a gradient."""
    name, _, _, demod, scale = form
    c = 3 if name == "to_rgb" else c
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64)  # noqa: E731
    y = (rnd(n, c, h, h) * scale).to(device, dtype).contiguous(memory_format=CL).requires_grad_(True)
    b = (rnd(c) * 0.3).to(device, dtype).requires_grad_(True)
    if not demod:
        return y, None, None, None, b
    d = (rnd(n, c).abs() + 0.5).to(device, dtype).requires_grad_(True)
    noise = rnd(n, 1, h, h).to(device, dtype)
    ns = (rnd() * 0.5).to(device, dtype).requires_grad_(True)
    return y, d, noise, ns, b


def fused(form, y, d, noise, ns, b):
    _, act, gain, _, _ = form
    return ba.bias_act(y, b, d, noise, ns, act, gain)


def composite(form, y, d, noise, ns, b):
    """The model's ops before S5 (its ``bias_act`` and ``SynthesisLayer``'s tail)."""
    _, act, gain, _, _ = form
    clamp = 256.0
    if d is not None:
        y = y * d.to(y.dtype)[:, :, None, None] + (noise.float() * ns).to(y.dtype)
    x = conv_epilogue(y.contiguous(memory_format=CL), b)
    if act:
        x = r1_leaky_relu(x, 0.2) * (math.sqrt(2.0) * gain)
    elif gain != 1.0:
        x = x * gain
    return x.clamp(-clamp * gain, clamp * gain)


def leaves(ins):
    return [t for t in ins if t is not None and t.requires_grad]


@pytest.fixture
def calls(monkeypatch):
    """The Functions' calls, counted by wrapping them: ``fwd`` (the
    forward), ``bwd`` (the backward), ``bwd2`` (the backward's backward) and
    ``bwd2_out`` (those of its calls with an output, which the card's
    wrapper launches)."""
    counted = collections.Counter()

    def counting(kind, fn):
        def call(*a):
            counted[kind] += 1
            out = fn(*a)
            if kind == "bwd2" and any(t is not None for t in out):
                counted["bwd2_out"] += 1
            return out
        return staticmethod(call)

    monkeypatch.setattr(ba.BiasAct, "forward", counting("fwd", ba.BiasAct.forward))
    monkeypatch.setattr(ba.BiasActBwd, "forward", counting("bwd", ba.BiasActBwd.forward))
    monkeypatch.setattr(ba.BiasActBwd, "backward", counting("bwd2", ba.BiasActBwd.backward))
    return counted


def launches():
    return tuple(c.value for c in (ba.LAUNCHES, ba.BWD_LAUNCHES, ba.BWD2_LAUNCHES))


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_forward_and_gradients_equal_the_composite_ops(form):
    ins = inputs(form)
    got, want = fused(form, *ins), composite(form, *ins)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if form[0] == "clamped":  # the clamp cuts both tails, and passes the rest
        bound = ba.CLAMP * form[2]
        assert (want == bound).any() and (want == -bound).any() and (want.abs() < bound).any()
    v = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    xs = leaves(ins)
    g_got = torch.autograd.grad(got, xs, v, create_graph=True)
    g_want = torch.autograd.grad(want, xs, v, create_graph=True)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # second order: a weighted sum of every first-order gradient, differentiated again
    ws = [torch.randn(t.shape, generator=torch.Generator().manual_seed(2 + i), dtype=t.dtype)
          for i, t in enumerate(g_got)]
    s_got = sum((a * w).sum() for a, w in zip(g_got, ws))
    s_want = sum((a * w).sum() for a, w in zip(g_want, ws))
    gg_got = torch.autograd.grad(s_got, xs, allow_unused=True, materialize_grads=True)
    if s_want.requires_grad:
        gg_want = torch.autograd.grad(s_want, xs, allow_unused=True, materialize_grads=True)
    else:  # without d the first-order gradients are linear in v alone: no second order
        gg_want = [torch.zeros_like(t) for t in xs]
    for a, b in zip(gg_got, gg_want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_gradcheck_and_gradgradcheck_in_float64(form):
    ins = inputs(form, torch.float64, n=2, c=4, h=3, seed=3)
    xs = leaves(ins)
    slots = [i for i, t in enumerate(ins) if t is not None and t.requires_grad]

    def f(*args):
        full = list(ins)
        for i, a in zip(slots, args):
            full[i] = a
        return fused(form, *full)

    assert torch.autograd.gradcheck(f, xs) and torch.autograd.gradgradcheck(f, xs)


def test_the_model_layers_run_through_s5(calls):
    """A modulated layer, ToRGB and a D conv each call S5 once forward and
    once backward; D's skip does not."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 4, 4, 4), generator=gen).contiguous(memory_format=CL)
    w = torch.randn((2, 8), generator=gen)
    noise = torch.randn((2, 1, 4, 4), generator=gen)
    for layer, run in ((sm.SynthesisLayer(4, 6, 8, 1), lambda m: m(x, w, noise)),
                       (sm.ToRGB(4, 8), lambda m: m(x, w)), (sm.DConv(4, 6, 3), lambda m: m(x, math.sqrt(0.5))),
                       (sm.DConv(4, 6, 1, bias=False, down=2), lambda m: m(x, math.sqrt(0.5)))):
        before = (calls["fwd"], calls["bwd"])
        run(layer).sum().backward()
        want = (0, 0) if layer.bias is None else (1, 1)
        assert (calls["fwd"] - before[0], calls["bwd"] - before[1]) == want, type(layer)


def test_calls_per_lazy_period(calls):
    """S5's calls an iteration at 256² (tiny widths): 82 forward and 62
    backward on every iteration (G 20 epilogues a pass, D 14), 20 and 33
    more with path length (its first backward through G, and 13 calls of
    the forward Functions' backwards inside its double backward), 14 and 27
    more with R1: 1,406 and 1,151 in a 16-iteration period (G reg on 4, D
    reg on 1). The second order runs 20 times in path length's double
    backward, 13 of them with an output (ToRGB's 7 have none: no gradient
    reaches g, y or d), and 14 times in R1's, each with one: 66 launches a
    period on the card."""
    from littlegan_tpu_torch.training import stylegan2 as ts
    from littlegan_tpu_torch.training.state import create_stylegan2_state
    from test_torch_stylegan2 import tiny_cfg

    cfg = tiny_cfg(image_dim=256, channel_base=512, channel_max=4, batch_size=2, mbstd_group=2)
    gen = torch.Generator().manual_seed(7)
    state = create_stylegan2_state(cfg, "cpu", sm.init_params(sm.StyleGAN2(cfg), 0))
    images = torch.randint(0, 256, (4, 256, 256, 3), dtype=torch.uint8, generator=gen)
    counted = {}
    kinds = ("fwd", "bwd", "bwd2", "bwd2_out")
    for it in (1, 4, 0):
        draws = ts.stack_draws([ts.draw_iteration(gen, cfg, "cpu", it, 4)])
        before = [calls[k] for k in kinds]
        ts.eager_iterations(state, cfg, images, draws, it)
        counted[ts.pattern(cfg, it, 1)[0]] = tuple(calls[k] - b for k, b in zip(kinds, before))
    assert counted == {(False, False): (82, 62, 0, 0), (True, False): (102, 95, 20, 13),
                       (True, True): (116, 122, 34, 27)}
    period = [sum(counted[p][j] for p in ts.pattern(cfg, 0, 16)) for j in range(4)]
    assert period == [1406, 1151, 94, 66]


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_counters_count_once_per_call(form, calls):
    """Each Function runs once per call; the launch counters stay where
    they are on the CPU, which launches nothing."""
    ins = inputs(form)
    before = launches()
    out = fused(form, *ins)
    assert (calls["fwd"], calls["bwd"], calls["bwd2"]) == (1, 0, 0)
    g = torch.autograd.grad(out.sum(), leaves(ins), create_graph=True)
    assert (calls["fwd"], calls["bwd"], calls["bwd2"]) == (1, 1, 0)
    torch.autograd.grad(sum(t.sum() for t in g), leaves(ins), allow_unused=True)
    assert (calls["fwd"], calls["bwd"], calls["bwd2"]) == (1, 1, 1)
    assert launches() == before


@pytest.mark.parametrize("given", ["d", "noise", "d_noise"])
def test_the_modulation_comes_whole(given):
    """d, the noise and its strength come together (a modulated layer) or
    not at all (every other layer)."""
    y, d, noise, ns, b = inputs(FORMS[0])
    parts = {"d": (d, None, None), "noise": (None, noise, ns), "d_noise": (d, noise, None)}[given]
    with pytest.raises(ValueError, match="together"):
        ba.bias_act(y, b, *parts)


def test_only_the_wanted_reductions_are_formed():
    y, d, noise, ns, b = inputs(FORMS[0])
    g = torch.randn_like(y)
    k = ba.slopes(True, 1.0)
    full = ba.bias_act_bwd_plain(g, y, d, noise, ns, b, k, True, True, True)
    assert all(t is not None for t in full)
    none = ba.bias_act_bwd_plain(g, y, d, noise, ns, b, k, False, False, False)
    assert torch.equal(none[0], full[0]) and none[1:] == (None, None, None)
    # b's gradient is the column sum of gpre, gpre = gy / d
    torch.testing.assert_close(full[2], (full[0] / d[:, :, None, None]).sum((0, 2, 3)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,c,hw,vec", [(64, 64, 65536, 8), (64, 512, 16, 8), (64, 3, 65536, 1), (8, 512, 1024, 4),
                                        (1, 5, 7, 1)])
def test_backward_plan_covers_every_pixel(n, c, hw, vec):
    splits, chunk = ba.plan(n, c, hw, vec, 132)
    assert splits >= 1 and (splits - 1) * chunk < hw <= splits * chunk
    rows = 256 // -(-min(64, c) // vec)
    assert splits == 1 or chunk >= rows * ba._MIN_ITERS - rows


def test_kernel_wrappers_refuse_a_cpu_tensor():
    y, d, noise, ns, b = inputs(FORMS[0])
    k = ba.slopes(True, 1.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ba.bias_act_kernel(y.detach(), d, noise, ns, b, k)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ba.bias_act_bwd_kernel(y.detach(), y.detach(), d, noise, ns, b, k, True, True, True)


# ---------------------------------------------------------------------------
# The card


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (layer, C, H): the StyleGAN2 iteration's epilogue shapes at FFHQ 256² (channel_base 16384, channel_max 512)
CARD_SHAPES = ([("g_layer", 512, r) for r in (4, 16, 32)] + [("g_layer", 256, 64), ("g_layer", 128, 128),
                                                            ("g_layer", 64, 256)]
               + [("to_rgb", 3, r) for r in (8, 256)]
               + [("d_conv", 64, 256), ("d_conv", 128, 128), ("d_conv", 512, 16), ("d_conv", 512, 4)])
FORM_OF = {f[0]: f for f in FORMS}
ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -23}  # one rounding of the output, relative
SUM_REL = 1e-5  # f32 sums in another order, relative to the sum of magnitudes


def _card_case(dev, dtype, what, c, h, seed):
    form = FORM_OF[what]
    ins = [None if t is None else t.detach() for t in inputs(form, torch.float32, 8, c, h, seed, dev)]
    y, d, noise, ns, b = ins
    y = (y * 60).to(dtype).contiguous(memory_format=CL)  # past the clamp of 256 in places at the 4² maps too
    noise = None if noise is None else noise.to(dtype)
    g = torch.randn(y.shape, device=dev).to(dtype).contiguous(memory_format=CL)
    return form, (y, d, noise, ns, b), g


def _close(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    return bool((diff <= ROUNDING[dtype] * want.float().abs() + 1e-30).all())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("what,c,h", CARD_SHAPES, ids=[f"{w}-{c}-{h}" for w, c, h in CARD_SHAPES])
def test_kernels_equal_the_plain_versions(card, dtype, what, c, h):
    form, (y, d, noise, ns, b), g = _card_case(card, dtype, what, c, h, c + h)
    k = ba.slopes(form[1], form[2])
    out = ba.bias_act_kernel(y, d, noise, ns, b, k)
    want = ba.bias_act_plain(y, d, noise, ns, b, k)
    torch.cuda.synchronize(card)
    assert out.is_contiguous(memory_format=CL) and out.dtype == dtype and _close(out, want, dtype)
    got = ba.bias_act_bwd_kernel(g, y, d, noise, ns, b, k, True, True, True)
    ref = ba.bias_act_bwd_plain(g, y, d, noise, ns, b, k, True, True, True)
    assert got[0].is_contiguous(memory_format=CL) and _close(got[0], ref[0], dtype)
    gp = g.float() * ba._slope_kept(y, d, noise, ns, b, k)[1]
    mags = [None if d is None else (gp * y.float()).abs().sum((2, 3)), gp.abs().sum((0, 2, 3)),
            None if noise is None else (gp * noise.float()).abs().sum()]
    for a, r, m in zip(got[1:], ref[1:], mags):
        assert (a is None) == (r is None)
        if a is not None:
            assert bool(((a - r).abs() <= SUM_REL * m + 1e-30).all())
    # the second order, with every gradient of the backward's outputs given
    ggy = torch.randn(y.shape, device=card).to(dtype).contiguous(memory_format=CL)
    ggd = None if d is None else torch.randn(d.shape, device=card)
    ggb, ggns = torch.randn(b.shape, device=card), None if noise is None else torch.randn((), device=card)
    got2 = ba.bias_act_bwd2_kernel(g, y, d, noise, ns, b, k, ggy, ggd, ggb, ggns, True, True, True)
    ref2 = ba.bias_act_bwd2_plain(g, y, d, noise, ns, b, k, ggy, ggd, ggb, ggns, True, True, True)
    torch.cuda.synchronize(card)
    assert _close(got2[0], ref2[0], dtype)
    assert (got2[1] is None) == (d is None) and (got2[1] is None or _close(got2[1], ref2[1], dtype))
    if d is not None:
        m = (ggy.float() * g.float() * ba._slope_kept(y, d, noise, ns, b, k)[1]).abs().sum((2, 3))
        assert bool(((got2[2] - ref2[2]).abs() <= SUM_REL * m + 1e-30).all())


@pytest.mark.card
@pytest.mark.parametrize("what,c,h", [("g_layer", 64, 256), ("d_conv", 512, 16), ("to_rgb", 3, 256)],
                         ids=["g_layer-64-256", "d_conv-512-16", "to_rgb-3-256"])
def test_reductions_are_the_same_bits_on_every_call(card, what, c, h):
    form, (y, d, noise, ns, b), g = _card_case(card, torch.bfloat16, what, c, h, 7)
    k = ba.slopes(form[1], form[2])
    first = ba.bias_act_bwd_kernel(g, y, d, noise, ns, b, k, True, True, True)
    again = ba.bias_act_bwd_kernel(g, y, d, noise, ns, b, k, True, True, True)
    for a, r in zip(first, again):
        assert (a is None and r is None) or torch.equal(a, r)
    if d is not None:
        ggy = torch.randn(y.shape, device=card).to(y.dtype).contiguous(memory_format=CL)
        one = ba.bias_act_bwd2_kernel(g, y, d, noise, ns, b, k, ggy, None, None, None, False, False, True)[2]
        two = ba.bias_act_bwd2_kernel(g, y, d, noise, ns, b, k, ggy, None, None, None, False, False, True)[2]
        assert torch.equal(one, two)


@pytest.mark.card
def test_kernels_read_a_strided_noise_view_and_an_nchw_gradient(card):
    """The noise map as the model hands it (a (N, 1, H, W) view of the
    drawn (N, sum of res^2) row) and a gradient in NCHW memory."""
    form, (y, d, _, ns, b), g = _card_case(card, torch.bfloat16, "g_layer", 64, 16, 9)
    row = torch.randn((8, 3 * 256), device=card).to(torch.bfloat16)
    noise = row[:, 256:512].view(8, 1, 16, 16)
    k = ba.slopes(True, 1.0)
    out = ba.bias_act_kernel(y, d, noise, ns, b, k)
    assert torch.equal(out, ba.bias_act_kernel(y, d, noise.contiguous(), ns, b, k))
    got = ba.bias_act_bwd_kernel(g.contiguous(), y, d, noise, ns, b, k, True, True, True)
    want = ba.bias_act_bwd_kernel(g, y, d, noise.contiguous(), ns, b, k, True, True, True)
    for a, r in zip(got, want):
        assert torch.equal(a, r)


@pytest.mark.card
def test_counters_count_launches_on_the_card(card):
    """One count a launch of each wrapper's kernel; a second order with no
    output launches nothing and counts nothing; under plain_versions
    nothing moves."""
    from littlegan_tpu_torch.ops.cuda import _build

    form, ins, _ = _card_case(card, torch.bfloat16, "g_layer", 64, 16, 11)
    y, d, noise, ns, b = ins
    y, d, ns, b = (t.clone().requires_grad_(True) for t in (y, d, ns, b))
    before = launches()
    out = ba.bias_act(y, b, d, noise, ns)
    v = torch.randn(out.shape, device=card)
    g = torch.autograd.grad((out.float() * v).sum(), [y, d, ns, b], create_graph=True)
    torch.autograd.grad(sum(t.float().sum() for t in g), [y, d], allow_unused=True)
    assert tuple(a - c for a, c in zip(launches(), before)) == (1, 1, 1)
    y2, _, _, _, b2 = _card_case(card, torch.bfloat16, "to_rgb", 3, 16, 12)[1]
    before = launches()
    gy = torch.autograd.grad(ba.bias_act(y2.requires_grad_(True), b2, act=False).float().sum(), [y2],
                             create_graph=True)[0]
    assert torch.autograd.grad(gy.float().sum(), [y2], allow_unused=True) == (None,)  # nothing reaches g, y, d
    assert tuple(a - c for a, c in zip(launches(), before)) == (1, 1, 0)
    before = launches()
    with _build.plain_versions():
        ba.bias_act(y2, b2, act=False).float().sum().backward()
    assert launches() == before
