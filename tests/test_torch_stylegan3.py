"""StyleGAN3-T on the port's training path, against the plain float32
reference ``benchmark/reference/stylegan3.py`` (plain torch, imports
nothing of the port), on the CPU at a tiny size: 32² images, widths up to
16, batch 4, minibatch-stddev groups of 2, float32 compute.

- the layer schedule at 512² (sizes, widths, factors, taps, paddings) and
  the Kaiser filters against ``scipy.signal.firwin``;
- S6's plain version against the reference's four steps in float64, in
  each resampling form (up 2, up 4 with a crop, the last layer's crop):
  the output and the gradients of y, d and b; its backward's backward
  raises; the kernel's mask words read back as the plain version's maps;
- G's forward and its gradients against the reference on seeded weights;
- 16 iterations (one lazy period, Dreg on the first) through the K-iteration
  scan against the reference: the losses, parameters, EMA, ``w_avg`` and
  every ``magnitude_ema``; the EMAs move in Dmain's pass alone;
- StyleGAN2's iteration computing the numbers it did before its fixed
  settings became configuration fields;
- the refusals, and ``python -m littlegan_tpu_torch train`` with
  ``model: stylegan3``.

On a card (marked ``card``; skips without one): S6's kernels against the
plain version at small shapes of each form, bf16 and float32, and an
iteration through the kernels against the plain versions. On the card:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_stylegan3.py -m card``.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models import stylegan3 as m3
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda import filtered_lrelu as fl
from littlegan_tpu_torch.training import stylegan2 as ts
from littlegan_tpu_torch.training.state import create_stylegan2_state
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference import stylegan2 as ref2  # noqa: E402
from benchmark.reference import stylegan3 as ref  # noqa: E402

TINY = dict(image_dim=32, batch_size=4, channel_base=128, channel_max=16, z_dim=8, w_dim=8, mapping_layers=2,
            mbstd_group=2, lr=0.0025, d_lr=0.002, beta_1=0.0, beta_2=0.99, g_reg_interval=0, d_reg_interval=16,
            r1_gamma=8.2, pl_weight=0.0, style_mixing=0.0, ema_kimg=0.01, ema_rampup=0.05)
N_STORE = 12
CL = torch.channels_last

# the StyleGAN3 cell's layers at 512²: (name, cin, cout, in, out, up, down, up taps, pad lo, pad hi)
TABLE = [("L0_36_512", 512, 512, 36, 36, 2, 2, 12, 9, 8), ("L1_36_512", 512, 512, 36, 36, 2, 2, 12, 9, 8),
         ("L2_52_512", 512, 512, 36, 52, 4, 2, 24, -6, -9), ("L3_52_512", 512, 512, 52, 52, 2, 2, 12, 9, 8),
         ("L4_84_512", 512, 512, 52, 84, 4, 2, 24, -6, -9), ("L5_84_512", 512, 512, 84, 84, 2, 2, 12, 9, 8),
         ("L6_148_512", 512, 512, 84, 148, 4, 2, 24, -6, -9), ("L7_148_483", 512, 483, 148, 148, 2, 2, 12, 9, 8),
         ("L8_276_323", 483, 323, 148, 276, 4, 2, 24, -6, -9), ("L9_276_215", 323, 215, 276, 276, 2, 2, 12, 9, 8),
         ("L10_532_144", 215, 144, 276, 532, 4, 2, 24, -6, -9), ("L11_532_96", 144, 96, 532, 532, 2, 2, 12, 9, 8),
         ("L12_532_64", 96, 64, 532, 532, 2, 2, 12, 9, 8), ("L13_512_64", 64, 64, 532, 512, 2, 2, 12, -11, -12),
         ("L14_512_3", 64, 3, 512, 512, 1, 1, 0, 0, 0)]


def tiny_cfg(**kw) -> Config:
    return Config(**{"model": "stylegan3", "compute_dtype": "float32", "use_s2d": False, "device_data": True,
                     **TINY, **kw})


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(2026)
    rmodel = ref.Model.from_config(TINY)
    p0, buf0 = ref.init_params(rmodel, gen, "cpu")
    images = torch.randint(0, 256, (N_STORE, 32, 32, 3), dtype=torch.uint8, generator=gen)
    return p0, buf0, images


def port_state(cfg: Config, p0, buf0):
    model = m3.StyleGAN3(cfg)
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for n, prm in model.named_parameters():
            prm.copy_(p0[n])
        for n, t in buf0.items():
            buffers[n].copy_(t)
    return create_stylegan2_state(cfg, "cpu", model)


def test_schedule_reproduces_the_published_table():
    plan, layers = m3.schedule(512, 32768, 512)
    assert plan == m3.InputPlan(512, 36, 16.0, 2.0)
    got = [(x.name, x.cin, x.cout, x.in_size, x.out_size, x.up, x.down, len(x.up_filter), *x.padding)
           for x in layers]
    assert got == TABLE
    assert all(len(x.down_filter) == 12 for x in layers[:-1]) and layers[-1].torgb and not layers[-1].down_filter
    ref_plan, ref_layers = ref.schedule(512, 32768, 512)  # the reference's own
    assert [(x.name, x.cin, x.cout, x.in_size, x.out_size, x.up, x.down, *x.pad) for x in ref_layers] == [
        t[:7] + t[8:] for t in TABLE]
    assert ref_plan == tuple(plan)
    assert m3.num_ws() == 16


def test_kaiser_filters_match_firwin():
    signal = pytest.importorskip("scipy.signal")
    res = 512
    exps = np.minimum(np.arange(15) / 12, 1)
    cutoffs = 2 * (res / 2 / 2) ** exps
    stop = 2 ** 2.1 * (res / 2 * 2 ** 0.3 / 2 ** 2.1) ** exps
    rates = np.exp2(np.ceil(np.log2(np.minimum(stop * 2, res))))
    half = np.maximum(stop, rates / 2) - cutoffs
    for i, layer in enumerate(m3.schedule(res, 32768, 512)[1][:-1]):
        tmp = max(rates[max(i - 1, 0)], rates[i]) * 2
        fu = signal.firwin(len(layer.up_filter), cutoffs[max(i - 1, 0)], width=half[max(i - 1, 0)] * 2, fs=tmp)
        fd = signal.firwin(12, cutoffs[i], width=half[i] * 2, fs=tmp)
        np.testing.assert_allclose(layer.up_filter, fu, rtol=0, atol=1e-12)
        np.testing.assert_allclose(layer.down_filter, fd, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ref.kaiser_lowpass(12, cutoffs[i], half[i] * 2, tmp), fd, rtol=0, atol=1e-12)


def published_upfirdn2d(x, f, up=1, down=1, pad=(0, 0), gain=1.0):
    """NVlabs' ``_upfirdn2d_ref`` for a separable filter: zero insertion,
    padding or cropping, two depthwise convs, every ``down``-th sample."""
    n, c, h, w = x.shape
    x = torch.nn.functional.pad(x.reshape(n, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    lo, hi = pad
    x = torch.nn.functional.pad(x, [max(lo, 0), max(hi, 0), max(lo, 0), max(hi, 0)])
    x = x[:, :, max(-lo, 0):x.shape[2] - max(-hi, 0), max(-lo, 0):x.shape[3] - max(-hi, 0)]
    k = (f * gain ** 0.5).flip(0)[None, None].repeat(c, 1, 1)
    x = torch.nn.functional.conv2d(x, k.unsqueeze(2), groups=c)
    x = torch.nn.functional.conv2d(x, k.unsqueeze(3), groups=c)
    return x[:, :, ::down, ::down]


@pytest.mark.parametrize("index", [0, 2, 10, 13], ids=["L0-up2", "L2-up4-crop", "L10-up4", "L13-crop"])
def test_reference_filter_equals_the_published_upfirdn2d(index):
    """The reference's banded filter (``fir1d``) against the published
    zero-inserted depthwise convs at a layer of the 512² cell, up and down,
    forward and the input's gradient, in float64."""
    layer = m3.schedule(512, 32768, 512)[1][index]
    gen = torch.Generator().manual_seed(index)
    y = torch.randn((1, 2, layer.in_size + 2, layer.in_size + 2), generator=gen, dtype=torch.float64)
    for f, up, down, pad in ((layer.up_filter, layer.up, 1, layer.padding), (layer.down_filter, 1, layer.down, (0, 0))):
        f = torch.tensor(f, dtype=torch.float64)
        ya, yb = y.clone().requires_grad_(True), y.clone().requires_grad_(True)
        got, want = ref.upfirdn2d(ya, f, up, down, pad, up ** 2), published_upfirdn2d(yb, f, up, down, pad, up ** 2)
        assert got.shape == want.shape
        g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        (got * g).sum().backward()
        (want * g).sum().backward()
        for a, r in ((got, want), (ya.grad, yb.grad)):
            assert float((a - r).abs().max()) <= 1e-13 * float(r.abs().max())
        y = want.detach()


# (layer index at 64², its form): up 2, up 4 with negative padding, the last layer's crop
S6_CASES = [(0, "up2"), (4, "up4-crop"), (13, "last-crop")]


@pytest.mark.parametrize("index,form", S6_CASES, ids=[f for _, f in S6_CASES])
def test_filtered_lrelu_plain_equals_the_reference(index, form):
    layer = m3.schedule(64, 256, 16)[1][index]
    hc, c = layer.in_size + 2, 5
    gen = torch.Generator().manual_seed(index)
    y = torch.randn((2, c, hc, hc), generator=gen, dtype=torch.float64) * 30  # past the clamp in places
    b, d = torch.randn((c,), generator=gen, dtype=torch.float64), torch.rand((2, c), generator=gen,
                                                                              dtype=torch.float64) + 0.5
    fu, fd = (torch.tensor(f, dtype=torch.float64) for f in (layer.up_filter, layer.down_filter))
    lo, hi = layer.padding
    spec = fl.make_spec(hc, hc, layer.up_filter, layer.down_filter, layer.up, layer.down, (lo, hi, lo, hi),
                        math.sqrt(2), 0.2, 256.0)
    yy, bb, dd = (t.clone().requires_grad_(True) for t in (y, b, d))
    yr, br, dr = (t.clone().requires_grad_(True) for t in (y, b, d))
    got = fl.filtered_lrelu(yy, bb, dd, fu, fd, spec)
    want = ref.filtered_lrelu(yr * dr[:, :, None, None], fu, fd, br, layer.up, layer.down, layer.padding)
    assert got.shape == want.shape == (2, c, layer.out_size, layer.out_size)
    assert bool((want.abs() > 1).any()) and bool((got.detach().abs() <= 256).all())
    g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    (got * g).sum().backward()
    (want * g).sum().backward()
    for a, r in ((got, want), (yy.grad, yr.grad), (bb.grad, br.grad), (dd.grad, dr.grad)):
        assert float((a - r).abs().max()) <= 1e-12 * float(r.abs().max())
    # first order only: the backward's backward raises
    yy2 = y.clone().requires_grad_(True)
    (gy,) = torch.autograd.grad((fl.filtered_lrelu(yy2, b, d, fu, fd, spec) * g).sum(), yy2, create_graph=True)
    with pytest.raises(RuntimeError):
        gy.sum().backward()


def test_smoke_tolerance_sees_a_shift_beside_clamped_channels():
    """``chip_smoke.py`` phase (r)'s output check, at its input's form (every
    tenth channel clamps at 256): another rounding of the right output
    passes, and a ``pad_lo`` one sample off fails on the unclamped channels."""
    import chip_smoke

    layer = m3.schedule(64, 256, 16)[1][0]
    hc, c = layer.in_size + 2, 20
    gen = torch.Generator().manual_seed(5)
    scale = torch.ones(c)
    scale[::10] = 100.0
    y = torch.randn((1, c, hc, hc), generator=gen, dtype=torch.float64) * 3 * scale[:, None, None]
    b, d = torch.randn((c,), generator=gen, dtype=torch.float64) * 0.2, torch.rand((1, c), generator=gen,
                                                                                    dtype=torch.float64) + 0.5
    fu, fd = (torch.tensor(f, dtype=torch.float64) for f in (layer.up_filter, layer.down_filter))
    lo, hi = layer.padding

    def out(pad, dtype):
        spec = fl.make_spec(hc, hc, layer.up_filter, layer.down_filter, layer.up, layer.down, pad,
                            math.sqrt(2), 0.2, 256.0)
        return fl.forward_plain(y.to(dtype), b.to(dtype), d.to(dtype), fu.to(dtype), fd.to(dtype),
                                spec)[0].to(torch.bfloat16)

    groups = ((torch.arange(c) % 10 != 0).nonzero().squeeze(1), torch.arange(0, c, 10))
    want = out((lo, hi, lo, hi), torch.float32)
    assert bool((want[:, 0].float().abs() == 256).any())
    assert chip_smoke._rounding_err(out((lo, hi, lo, hi), torch.float64), want, groups) <= chip_smoke.SG3_ROUNDING
    shifted = out((lo + 1, hi - 1, lo + 1, hi - 1), torch.float32)
    assert chip_smoke._rounding_err(shifted, want, groups) > 10 * chip_smoke.SG3_ROUNDING


def test_kernel_mask_words_read_as_the_plain_maps():
    """The 16-bit words the kernel writes: bit k the sign of channel 8w + k, bit 8 + k its clamp."""
    n, t, c = 1, 3, 11
    neg = torch.rand((n, c, t, t)) < 0.5
    cut = torch.rand((n, c, t, t)) < 0.2
    words = torch.zeros((n, t, t, 2), dtype=torch.int32)
    for ch in range(c):
        words[..., ch // 8] |= neg[:, ch].int() << (ch % 8) | cut[:, ch].int() << (8 + ch % 8)
    got = fl.unpack_mask(words.to(torch.int16), c)
    assert torch.equal(got[0], neg) and torch.equal(got[1], cut)


def test_synthesis_and_its_gradients_equal_the_reference(setup):
    p0, buf0, _ = setup
    cfg = tiny_cfg()
    state = port_state(cfg, p0, buf0)
    model, rmodel = state.model, ref.Model.from_config(TINY)
    gen = torch.Generator().manual_seed(3)
    ws = torch.randn((4, 16, 8), generator=gen)
    g = torch.randn((4, 3, 32, 32), generator=gen)
    img = model.G.synthesis(ws)
    p = ref2.leaves(p0)
    want = rmodel.synthesis(p, buf0, ws)
    assert img.shape == (4, 3, 32, 32)
    assert float((img - want).abs().max()) <= 1e-5 * float(want.abs().max())
    names = [n for n, _ in model.G.synthesis.named_parameters()]
    got_g = torch.autograd.grad((img * g).sum(), [dict(model.G.synthesis.named_parameters())[n] for n in names])
    want_g = torch.autograd.grad((want * g).sum(), [p["G.synthesis." + n] for n in names], allow_unused=True)
    for n, a, r in zip(names, got_g, want_g):
        assert float((a - r).abs().max()) <= 1e-4 * max(float(r.abs().max()), 1e-12), n


def test_emas_move_in_dmain_alone(setup):
    p0, buf0, images = setup
    cfg = tiny_cfg()
    state = port_state(cfg, p0, buf0)
    gen = torch.Generator().manual_seed(5)
    d = ts.draw_iteration(gen, cfg, "cpu", 1, N_STORE)
    before = {k: v.clone() for k, v in ts.trained_buffers(state.model).items()}
    assert len(before) == 1 + 15 and set(before) == {k for k in buf0 if not k.startswith("G.synthesis.input")}
    ts.g_main(state, cfg, d.g_main)
    assert all(torch.equal(before[k], v) for k, v in ts.trained_buffers(state.model).items())
    ts.d_main(state, cfg, d.d_main, ts.real_images(images, d.ids, d.flips))
    assert all(not torch.equal(before[k], v) for k, v in ts.trained_buffers(state.model).items())


def test_lazy_period_scan_equals_the_reference(setup):
    """16 iterations (Dreg on the first) through the K-iteration step on the
    CPU, against the reference's iterations on the same draws."""
    p0, buf0, images = setup
    small = dict(lr=2.5e-5, d_lr=2e-5)  # the cell's check step: at the published one the two float32 runs part
    cfg = tiny_cfg(**small)
    state = port_state(cfg, p0, buf0)
    k = 16
    gen = torch.Generator().manual_seed(7)
    draws = ts.stack_draws([ts.draw_iteration(gen, cfg, "cpu", it, N_STORE) for it in range(k)])
    got = ts.make_stylegan2_scan_step(cfg, state, k)(state, images, draws, 0)
    rmodel, hp = ref.Model.from_config(TINY), ref.Hyper.from_config({**TINY, **small})
    p = ref2.leaves(p0)
    opts, run = ref.adams(p, hp), ref.new_run(p, buf0)
    pat = ts.pattern(cfg, 0, k)
    want = []
    for i in range(k):
        d = ts.draw_at(draws, pat, i)
        want.append(ref.iteration(rmodel, p, opts, run, ts.real_images(images, d.ids, d.flips),
                                  {"g_main": {"z": d.g_main.z}, "d_main": {"z": d.d_main.z}}, i, hp, chunk=2))
    want = torch.stack(want)
    assert pat[0] == (False, True) and all(r == (False, False) for r in pat[1:])
    assert float(got[0, ts.LOSS_KEYS.index("r1_penalty")]) > 0 and float(got[:, 1].abs().max()) == 0
    assert float(((got - want).abs() / want.abs().clamp_min(1e-6)).max()) < 1e-4
    live = dict(state.model.named_parameters())
    for name, v in p.items():
        moved = float((v - p0[name]).norm())
        assert float((live[name].detach() - v).norm()) <= 2e-3 * max(moved, 1e-9) + 1e-7, name
    for name, e in run.ema.items():
        assert float((state.ema[name] - e).norm()) <= 1e-4 * max(float(e.norm()), 1e-9) + 1e-7, name
    for name, b in ts.trained_buffers(state.model).items():
        assert float((b - run.buf[name]).abs().max()) <= 1e-5 * max(float(run.buf[name].abs().max()), 1e-9), name
        assert not torch.equal(b, buf0[name])


def test_stylegan2_iteration_computes_what_it_did_before():
    """Four iterations (Greg on two, Dreg on one) of a tiny StyleGAN2 with
    paper256's settings, now configuration fields: the numbers the program
    computed when they were constants of the training module."""
    cfg = Config(model="stylegan2", compute_dtype="float32", use_s2d=False, device_data=True, image_dim=16,
                 batch_size=4, channel_base=64, channel_max=16, z_dim=8, w_dim=8, mapping_layers=2, mbstd_group=2,
                 lr=0.0025, beta_1=0.0, beta_2=0.99, g_reg_interval=2, d_reg_interval=4, seed=7)
    assert (cfg.r1_gamma, cfg.pl_weight, cfg.style_mixing, cfg.ema_kimg, cfg.ema_rampup, cfg.d_lr) == (
        1.0, 2.0, 0.9, 20.0, 0.0, 0.0)
    state = create_stylegan2_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(11)
    images = torch.randint(0, 256, (12, 16, 16, 3), dtype=torch.uint8, generator=gen)
    draws = ts.stack_draws([ts.draw_iteration(gen, cfg, "cpu", it, 12) for it in range(4)])
    terms = ts.make_stylegan2_scan_step(cfg, state, 4)(state, images, draws, 0)
    # the parent's numbers with one thread (equal to these bit for bit); a host with other BLAS threads sums
    # in another order
    want = [3.00823837518692, 2.7462339401245117, 3.6143071055412292, 2.778173327445984, 0.007668943144381046,
            0.06464426219463348]
    assert terms.double().sum(0).tolist() == pytest.approx(want, rel=1e-6)
    with torch.no_grad():
        sq = {net: sum(float(p.double().square().sum()) for n, p in state.model.named_parameters()
                       if n.startswith(net + ".")) for net in ("G", "D")}
        sq["ema"] = sum(float(e.double().square().sum()) for e in state.ema.values())
    assert sq == pytest.approx({"G": 1167490.8451610957, "D": 8719.93473479418, "ema": 1167504.353107672}, rel=1e-9)


def test_refused_options_and_sizes():
    for kw, match in ((dict(image_dim=8), "at least 16"), (dict(use_s2d=True), "use_s2d"),
                      (dict(image_dim=48), "power-of-two"), (dict(batch_size=6, mbstd_group=4), "mbstd_group")):
        with pytest.raises(ValueError, match=match):
            m3.StyleGAN3(tiny_cfg(**kw))
    with pytest.raises(ValueError, match="trains"):
        ts.check_supported(tiny_cfg(model="littlegan"))


@pytest.mark.parametrize("mode", ["evaluate", "serve"])
def test_other_modes_exit_2(mode, monkeypatch, capsys):
    from littlegan_tpu_torch import cli

    monkeypatch.setattr(cli, "parse_config", lambda argv=None: tiny_cfg(mode=mode))
    assert cli.main([mode, "x"]) == 2
    assert "model stylegan3 runs only in train mode" in capsys.readouterr().err


def test_cli_trains_and_checkpoints(tmp_path, monkeypatch, capsys):
    """64 synthetic 16² images at batch 4: 16 iterations, 4 calls of K = 4."""
    from littlegan_tpu_torch.cli import main
    from littlegan_tpu_torch.training.checkpoint import Checkpointer

    monkeypatch.chdir(tmp_path)
    cfg = {**TINY, "model": "stylegan3", "image_dim": 16, "compute_dtype": "float32", "use_s2d": False,
           "device_data": True, "steps_per_dispatch": 4, "epoch": 1, "freq_gen": 8,
           "all_result_dir": str(tmp_path / "result")}
    (tmp_path / "sample.config.json").write_text(json.dumps(cfg))
    assert main(["train", "exp", "--debug", "--synthetic-data", "--device", "cpu"]) == 0
    assert "iteration 16:" in capsys.readouterr().out
    saved = Checkpointer(str(tmp_path / "result" / "exp" / "checkpoint")).restore_flat("1")
    assert ".buffers/G/synthesis/L0_36_16/magnitude_ema" in saved and ".buffers/G/mapping/w_avg" in saved
    assert float(saved[".buffers/G/synthesis/L0_36_16/magnitude_ema"]) != 1.0
    assert int(saved[".opt_g/.count/G/synthesis/input/weight"]) == 16
    assert (tmp_path / "result" / "exp" / "train" / "gen" / "1-8.jpg").is_file()


# ---------------------------------------------------------------------------
# The card


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (index at 128², batch, channels): each form, channels that fill whole and partial blocks
CARD_CASES = [(0, 3, 16), (4, 2, 13), (8, 2, 24), (13, 2, 8)]
ROUNDING = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("index,n,c", CARD_CASES, ids=[f"L{i}-c{c}" for i, _, c in CARD_CASES])
def test_kernels_equal_the_plain_version(card, dtype, index, n, c):
    layer = m3.schedule(128, 1024, 64)[1][index]
    hc = layer.in_size + 2
    lo, hi = layer.padding
    spec = fl.make_spec(hc, hc, layer.up_filter, layer.down_filter, layer.up, layer.down, (lo, hi, lo, hi),
                        math.sqrt(2), 0.2, 256.0)
    gen = torch.Generator(device=card).manual_seed(index * 100 + c)
    y = (torch.randn((n, c, hc, hc), generator=gen, device=card) * 40).to(dtype).contiguous(memory_format=CL)
    b = torch.randn((c,), generator=gen, device=card)
    d = torch.rand((n, c), generator=gen, device=card) + 0.5
    fu, fd = torch.tensor(layer.up_filter, device=card), torch.tensor(layer.down_filter, device=card)
    out, mask = fl.forward_kernel(y, b, d, spec)
    want, masks = fl.forward_plain(y, b, d, fu, fd, spec)
    assert float((out.float() - want.float()).abs().max()) <= ROUNDING[dtype] * float(want.float().abs().max())
    kmask = fl.unpack_mask(mask, c)
    assert float(((kmask[0] != masks[0]) | (kmask[1] != masks[1])).float().mean()) < 1e-3
    g = torch.randn(out.shape, generator=gen, device=card).to(dtype).contiguous(memory_format=CL)
    got = fl.backward_kernel(g, mask, y, d, spec, (y.shape, y.dtype))
    ref_b = fl.backward_plain(g, kmask, y, d, fu, fd, spec, True)
    for a, r, tol in zip(got, ref_b, (ROUNDING[dtype], 1e-4, 1e-4)):
        assert float((a.float() - r.float()).abs().max()) <= tol * float(r.float().abs().max())


@pytest.mark.card
def test_iteration_on_the_kernels_equals_the_plain_versions(card, setup):
    p0, buf0, images = setup
    cfg = tiny_cfg()
    gen = torch.Generator(device=card).manual_seed(3)
    draws = ts.stack_draws([ts.draw_iteration(gen, cfg, card, it, N_STORE) for it in range(2)])
    out = []
    for plain in (False, True):
        state = port_state(cfg, p0, buf0)
        state = create_stylegan2_state(cfg, card, state.model)
        before = _build.launch_counts()
        if plain:
            with _build.plain_versions():
                terms = ts.eager_iterations(state, cfg, images.to(card), draws, 0)
        else:
            terms = ts.eager_iterations(state, cfg, images.to(card), draws, 0)
        out.append(terms.cpu())
        assert _build.launch_counts()["stylegan3.filtered_lrelu"] - before["stylegan3.filtered_lrelu"] == 2 * 2 * 14
    assert float(((out[0] - out[1]).abs() / out[1].abs().clamp_min(1e-6)).max()) < 1e-4
