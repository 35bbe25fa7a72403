"""StyleGAN2 on the port's training path, against the plain float32
reference ``benchmark/reference/stylegan2.py`` (plain torch, imports
nothing of the port), on the CPU at a tiny size: 16² images, widths up to
16, batch 4, minibatch-stddev groups of 2, float32 compute.

- parameter names and shapes, and the published counts at 256²;
- G's and D's forward passes, one modulated conv, the minibatch stddev;
- S4's plain version in its three forms and their adjoints (``gradcheck``,
  a double backward, the reference's own ``upfirdn2d``);
- the path-length penalty and ``pl_mean``; the leaves a penalty's gradient
  does not reach, stepped with zeros, in the program and in the reference;
- one whole lazy period through the K-iteration scan against as many eager
  iterations (bit for bit) and against the reference, the reference also
  in chunks of one minibatch-stddev group;
- S4's launches per iteration against ``benchmark/roofline/stylegan2.py``'s
  count, the refused options and modes, ``python -m littlegan_tpu_torch
  train`` with a checkpoint and its resume.

On a card (marked ``card``; skips without one): S4 against its plain
version at the cell's shapes (batch 8), forward and adjoint, bf16 and
float32, and a tiny model's iteration through the kernels against the
plain versions. On the card: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_stylegan2.py -m card``.
"""

from __future__ import annotations

import math
import os
import sys

import pytest
import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models import stylegan2 as sm
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda import upfirdn2d as fir
from littlegan_tpu_torch.training import stylegan2 as ts
from littlegan_tpu_torch.training.state import create_stylegan2_state
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference import stylegan2 as ref  # noqa: E402
from benchmark.roofline import stylegan2 as roof  # noqa: E402

TINY = dict(image_dim=16, batch_size=4, channel_base=64, channel_max=16, z_dim=8, w_dim=8, mapping_layers=2,
            mbstd_group=2, lr=0.0025, beta_1=0.0, beta_2=0.99, g_reg_interval=4, d_reg_interval=16)
TINY_EMA_KIMG = 0.01  # an EMA that moves visibly over 16 iterations at batch 4
HYPER = {**TINY, "ema_kimg": TINY_EMA_KIMG}  # the reference's
N_STORE = 12
CL = torch.channels_last


@pytest.fixture(autouse=True)
def tiny_ema(monkeypatch):
    monkeypatch.setattr(ts, "EMA_KIMG", TINY_EMA_KIMG)


def tiny_cfg(**kw) -> Config:
    return Config(**{"model": "stylegan2", "compute_dtype": "float32", "use_s2d": False, "device_data": True,
                     **TINY, **kw})


def port_state(cfg: Config, p0):
    model = sm.StyleGAN2(cfg)
    with torch.no_grad():
        for n, prm in model.named_parameters():
            prm.copy_(p0[n])
    return create_stylegan2_state(cfg, "cpu", model)


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(2026)
    p0 = ref.init_params(ref.Model.from_config(TINY).shapes(), gen, "cpu")
    images = torch.randint(0, 256, (N_STORE, 16, 16, 3), dtype=torch.uint8, generator=gen)
    return p0, images


def ref_draws(d):
    g = lambda x: None if x is None else {"z": x.z, "z2": x.z2, "cutoff": x.cutoff, "noise": x.noise}  # noqa: E731
    return {"g_main": g(d.g_main), "d_main": g(d.d_main), "g_reg": g(d.g_reg), "pl_noise": d.pl_noise}


def test_parameter_names_and_shapes_are_the_published_ones(setup):
    p0, _ = setup
    model = sm.StyleGAN2(tiny_cfg())
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {k: tuple(v.shape) for k, v in p0.items()}
    assert list(dict(model.named_parameters())) == list(p0)
    assert [n for n, _ in model.named_buffers()] == ["G.mapping.w_avg"]
    assert model.G.synthesis.b8.conv0.weight.is_contiguous(memory_format=CL)


def test_published_sizes_at_256():
    cfg = tiny_cfg(image_dim=256, channel_base=16384, channel_max=512, z_dim=512, w_dim=512, mapping_layers=8,
                   mbstd_group=8, batch_size=64)
    with torch.device("meta"):
        model = sm.StyleGAN2(cfg)
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert (count(model.G), count(model.G.mapping), count(model.D)) == (24767458, 2101248, 24001089)
    assert sm.num_ws(256) == 14 and sum(r * r for r in sm.noise_sizes(256)) == 174736


def test_generator_and_discriminator_equal_the_reference(setup):
    p0, images = setup
    cfg = tiny_cfg()
    state = port_state(cfg, p0)
    m = ref.Model.from_config(TINY)
    gen = torch.Generator().manual_seed(1)
    d = ts.draw_g(gen, cfg, 4, "cpu")
    ws = ts.make_ws(state.model, cfg, d)
    want_ws = ref.styles(m, p0, {"z": d.z, "z2": d.z2, "cutoff": d.cutoff, "noise": d.noise},
                         ref.Run(torch.zeros(()), torch.zeros(8), None), ref.Hyper.from_config(HYPER),
                         torch.arange(4))
    torch.testing.assert_close(ws, want_ws, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        img = state.model.G.synthesis(ws, d.noise)
        torch.testing.assert_close(img, m.synthesis(p0, want_ws, d.noise.float()), rtol=1e-5, atol=1e-5)
        x = ts.real_images(images, torch.arange(4), torch.tensor([True, False, True, False]))
        torch.testing.assert_close(state.model.D(x), m.discriminator(p0, x), rtol=1e-5, atol=1e-5)
    # the mixing: cutoff 3 takes layers 3.. from z2's w, num_ws from none
    for cut, mixed in ((3, [3, 4, 5, 6, 7]), (sm.num_ws(16), [])):
        ws = ts.make_ws(state.model, cfg, d._replace(cutoff=torch.tensor(cut)))
        w1, w2 = state.model.G.mapping(d.z), state.model.G.mapping(d.z2)
        for layer in range(sm.num_ws(16)):
            torch.testing.assert_close(ws[:, layer], w2 if layer in mixed else w1)


@pytest.mark.parametrize("up", [False, True], ids=["conv1", "conv0_up"])
def test_modulated_conv_equals_the_published_form(up):
    """The port forms the demodulation as s^2 @ sum_k W^2 and runs the
    shared-weight conv between the scalings; the reference multiplies the
    weight per sample as published."""
    gen = torch.Generator().manual_seed(3)
    layer = sm.SynthesisLayer(6, 5, 8, 2 if up else 1)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn((3, 6, 8, 8), generator=gen).contiguous(memory_format=CL)
    w = torch.randn((3, 8), generator=gen)
    side = 16 if up else 8
    noise = torch.randn((3, 1, side, side), generator=gen)
    p = {"l." + n: v.detach() for n, v in layer.named_parameters()}
    want = ref.Model(image_dim=16)._modconv(p, "l", x, w, noise, up)
    torch.testing.assert_close(layer(x, w, noise), want, rtol=1e-5, atol=1e-5)
    bare = ref.Model(image_dim=16, fault="no_demod")._modconv(p, "l", x, w, noise, up)
    assert (bare - want).abs().max() > 0.1  # the demodulation is not a no-op here


def test_minibatch_stddev_groups_are_strided():
    x = torch.randn(8, 3, 4, 4, dtype=torch.float64)
    y = sm.minibatch_std(x, 4)
    torch.testing.assert_close(y, ref.mbstd(x, 4))
    # sample n is in group n % 2 (8 samples, groups of 4): {0, 2, 4, 6} and {1, 3, 5, 7}
    for n in range(8):
        grp = x[n % 2::2]
        want = (grp.var(0, unbiased=False) + 1e-8).sqrt().mean()
        torch.testing.assert_close(y[n, 3], torch.full((4, 4), float(want), dtype=torch.float64))


FIR_CASES = [(2, 1, 2, 1, 4.0, 5), (1, 1, 1, 1, 4.0, 9), (1, 1, 2, 2, 1.0, 8), (1, 2, 1, 1, 1.0, 8)]
FIR_IDS = ["up2", "conv0_filter", "conv1_prefilter", "down2"]


@pytest.mark.parametrize("up,down,p0,p1,gain,h", FIR_CASES, ids=FIR_IDS)
def test_fir_plain_equals_the_reference_and_differentiates(up, down, p0, p1, gain, h):
    x = torch.randn((2, 3, h, h), dtype=torch.float64, requires_grad=True)
    y = fir.upfirdn2d(x, up, down, p0, p1, gain)
    torch.testing.assert_close(y, ref.fir(x, up, down, (p0, p1), gain))
    f = lambda t: fir.upfirdn2d(t, up, down, p0, p1, gain)  # noqa: E731
    assert torch.autograd.gradcheck(f, (x,)) and torch.autograd.gradgradcheck(f, (x,))
    # the adjoint: <f(x), g> = <x, f*(g)>, and f*'s own backward is f
    g = torch.randn_like(y).requires_grad_(True)
    (gx,) = torch.autograd.grad(y, x, g, create_graph=True)
    torch.testing.assert_close((y * g).sum(), (x * gx).sum())
    before = (fir.CALLS.value, fir.BWD_CALLS.value)
    (ggx,) = torch.autograd.grad((gx * torch.ones_like(gx)).sum(), g, create_graph=True)
    torch.testing.assert_close(ggx, fir.upfirdn2d(torch.ones_like(x), up, down, p0, p1, gain))
    assert fir.CALLS.value - before[0] == 2 and fir.BWD_CALLS.value == before[1]


def test_path_length_and_pl_mean_equal_the_reference(setup):
    p0, _ = setup
    cfg = tiny_cfg()
    gen = torch.Generator().manual_seed(4)
    d = ts.draw_iteration(gen, cfg, "cpu", 0, N_STORE)
    state = port_state(cfg, p0)
    state.pl_mean.fill_(0.3)
    loss, pen = ts.path_length(state, cfg, d.g_reg, d.pl_noise)
    grads = torch.autograd.grad(loss, [p for n, p in state.model.named_parameters() if n.startswith("G.")],
                                materialize_grads=True)
    m, hp = ref.Model.from_config(TINY), ref.Hyper.from_config(HYPER)
    for chunk in (None, 1):  # the published form, and one sample at a time with the pl_mean coupling carried
        p = ref.leaves(p0)
        run = ref.Run(torch.tensor(0.3), torch.zeros(8), None)
        norms = {}
        want = ref.g_reg(m, p, None, run, ref_draws(d)["g_reg"], d.pl_noise, hp, chunk, grad_norms=norms)
        torch.testing.assert_close(pen, want, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(state.pl_mean, run.pl_mean, rtol=1e-6, atol=1e-8)
        got = [float(torch.linalg.vector_norm(g.double())) for g in grads]
        keys = [n for n in p0 if n.startswith("G.")]
        torch.testing.assert_close(torch.tensor(got), torch.tensor([norms[k] for k in keys]), rtol=1e-4, atol=1e-6)


def test_penalties_step_every_leaf_with_a_zero_gradient_where_they_do_not_reach(setup):
    """A penalty's gradient reaches no ToRGB bias (path length) and no bias
    of D's epilogue (R1). As the published losses' ``* 0`` terms arrange,
    those leaves get zeros and their network's Adam steps them: through the
    penalty's step such a leaf keeps its value, its second moment decays by
    beta_2 and its count moves on with the others'. The reference's
    gradients are zero on the same leaves."""
    p0, images = setup
    cfg = tiny_cfg()
    gen = torch.Generator().manual_seed(5)
    d = ts.draw_iteration(gen, cfg, "cpu", 0, N_STORE)
    state = port_state(cfg, p0)
    row = torch.from_numpy(ts.schedule_rows(state, cfg, [0]))[0]
    x = ts.real_images(images, d.ids, d.flips)
    m, hp = ref.Model.from_config(TINY), ref.Hyper.from_config(HYPER)
    unreached_of = {"G": lambda n: n.endswith(".torgb.bias"),
                    "D": lambda n: n in ("D.b4.conv.bias", "D.b4.fc.bias", "D.b4.out.bias")}
    for net, main, reg in (("G", lambda: ts.g_main(state, cfg, d.g_main),
                            lambda: ts.path_length(state, cfg, d.g_reg, d.pl_noise)[0]),
                           ("D", lambda: sum(ts.d_main(state, cfg, d.d_main, x)), lambda: ts.r1(state, cfg, x)[0])):
        col = 0 if net == "G" else 2
        adam = state.opt_g if net == "G" else state.opt_d
        ts._step(state, cfg, main(), col, row)
        named = [(n, p) for n, p in state.model.named_parameters() if n.startswith(net + ".")]
        loss = reg()
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True, retain_graph=True)
        unreached = {n for (n, _), g in zip(named, grads) if g is None}
        assert unreached == {n for n, _ in named if unreached_of[net](n)} and unreached
        before = {n: (p.detach().clone(), adam.nu[n].clone()) for n, p in named}
        ts._step(state, cfg, loss, col + 1, row)
        b2 = ts.lazy(cfg, net)[2]
        for n, prm in named:
            assert adam.count[n] == 2, n
            if n in unreached:
                assert torch.equal(prm, before[n][0]), n
                torch.testing.assert_close(adam.nu[n], before[n][1] * b2, rtol=1e-7, atol=0, msg=n)
                assert adam.nu[n].abs().max() > 0, n
        p = ref.leaves(p0)
        norms = {}
        run = ref.new_run(p, 8)
        if net == "G":
            ref.g_reg(m, p, None, run, ref_draws(d)["g_reg"], d.pl_noise, hp, grad_norms=norms)
        else:
            xr = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(m.discriminator(p, xr).sum(), xr, create_graph=True)
            ref._step(p, None, "D", [lambda: g.square().sum()], norms)
        assert {k for k, v in norms.items() if v == 0.0} == unreached


def test_lazy_period_scan_equals_eager_and_the_reference(setup):
    """16 iterations (Greg on 4, Dreg on 1) through the scan step, as
    eager iterations, and in the reference whole and in chunks of one
    minibatch-stddev group: terms, parameters, Adam counts, EMA."""
    p0, images = setup
    cfg = tiny_cfg()
    k = 16
    gen = torch.Generator().manual_seed(6)
    draws = ts.stack_draws([ts.draw_iteration(gen, cfg, "cpu", it, N_STORE) for it in range(k)])
    assert draws.g_reg.z.shape[0] == 4 and draws.pl_noise.shape[0] == 4
    state = port_state(cfg, p0)
    got = ts.make_stylegan2_scan_step(cfg, state, k)(state, images, draws, 0)
    eager = port_state(cfg, p0)
    want_eager = ts.eager_iterations(eager, cfg, images, draws, 0)
    assert torch.equal(got, want_eager)
    for (n, a), b in zip(state.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(a, b), n
    assert set(state.opt_g.count.values()) == {20} and set(state.opt_d.count.values()) == {17}
    m, hp = ref.Model.from_config(TINY), ref.Hyper.from_config(HYPER)
    pat = ts.pattern(cfg, 0, k)
    live = dict(state.model.named_parameters())
    for chunk in (None, 2):
        p = ref.leaves(p0)
        opts, run = ref.adams(p, hp), ref.new_run(p, 8)
        want = []
        for i in range(k):
            d = ts.draw_at(draws, pat, i)
            want.append(ref.iteration(m, p, opts, run, ts.real_images(images, d.ids, d.flips), ref_draws(d), i, hp,
                                      chunk))
        want = torch.stack(want)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
        assert (got[:, 1] != 0).sum() == 4 and (got[:, 4] != 0).sum() == 1
        for n, v in p.items():
            torch.testing.assert_close(live[n], v.detach(), rtol=1e-4, atol=1e-5, msg=n)
        for n, v in run.ema.items():
            torch.testing.assert_close(state.ema[n], v, rtol=1e-4, atol=1e-5, msg=n)
        torch.testing.assert_close(state.pl_mean, run.pl_mean, rtol=1e-5, atol=1e-7)


def test_fir_launches_per_iteration_match_the_roofline_count():
    """S4's counters over one eager iteration of each phase pattern at 256²
    (tiny widths) are the launches ``benchmark/roofline/stylegan2.py``
    bounds: 60 / 48 forward / adjoint on every iteration, 18 / 18 more with
    path length, 24 / 24 more with R1."""
    cfg = tiny_cfg(image_dim=256, channel_base=512, channel_max=4, batch_size=2, mbstd_group=2)
    gen = torch.Generator().manual_seed(7)
    state = create_stylegan2_state(cfg, "cpu", sm.init_params(sm.StyleGAN2(cfg), 0))
    images = torch.randint(0, 256, (4, 256, 256, 3), dtype=torch.uint8, generator=gen)
    cfgd = {k: getattr(cfg, k) for k in ("image_dim", "channel_base", "channel_max", "batch_size", "compute_dtype")}
    for it in (1, 0):
        draws = ts.stack_draws([ts.draw_iteration(gen, cfg, "cpu", it, 4)])
        before = (fir.CALLS.value, fir.BWD_CALLS.value)
        ts.eager_iterations(state, cfg, images, draws, it)
        counted = (fir.CALLS.value - before[0], fir.BWD_CALLS.value - before[1])
        want = roof.iteration_launches(cfgd, it == 0, it == 0)
        assert counted == (len(want["fwd"]), len(want["bwd"])) == ((60, 48) if it else (102, 90))


def test_refused_options_and_sizes():
    for kw, match in ((dict(use_s2d=True), "use_s2d"), (dict(use_gp=True), "use_gp"), (dict(remat=True), "remat"),
                      (dict(grad_accum=2), "grad_accum"), (dict(mesh_shape=[2]), "a mesh"),
                      (dict(image_dim=12), "power-of-two"), (dict(batch_size=6, mbstd_group=4), "mbstd_group")):
        with pytest.raises(ValueError, match=match):
            sm.StyleGAN2(tiny_cfg(**kw))
    from littlegan_tpu_torch.training.stylegan2_trainer import StyleGAN2Trainer
    from littlegan_tpu_torch.training.trainer import make_trainer

    with pytest.raises(ValueError, match="device_data"):
        StyleGAN2Trainer(tiny_cfg(device_data=False), None, device="cpu")
    with pytest.raises(ValueError, match="one card"):
        make_trainer(tiny_cfg(), None, device="cpu", group=object())
    with pytest.raises(ValueError, match="moment_dtype float32"):
        create_stylegan2_state(tiny_cfg(moment_dtype="bfloat16"), "cpu")


@pytest.mark.parametrize("mode", ["random-sample", "serve", "export-model", "evaluate"])
def test_other_modes_exit_2(mode, monkeypatch, capsys):
    from littlegan_tpu_torch import cli

    monkeypatch.setattr(cli, "parse_config", lambda argv=None: tiny_cfg(mode=mode))
    assert cli.main([mode, "x"]) == 2
    assert "model stylegan2 runs only in train mode" in capsys.readouterr().err


def test_image_folder_decodes_every_image_under_it(tmp_path):
    import numpy as np
    from PIL import Image

    from littlegan_tpu_torch.data.image_folder import ImageFolder

    rng = np.random.default_rng(0)
    for i, sub in enumerate(("00000", "00000", "01000")):
        os.makedirs(tmp_path / sub, exist_ok=True)
        size = 20 if i == 2 else 16  # one size is resized on load
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(tmp_path / sub / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    data = ImageFolder(tiny_cfg(image_path=str(tmp_path)))
    images = data.load()
    assert len(data) == 3 and images.shape == (3, 16, 16, 3) and images.dtype == np.uint8
    assert np.array_equal(images[0], np.asarray(Image.open(tmp_path / "00000" / "0.png")))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="no .jpg"):
        ImageFolder(tiny_cfg(image_path=str(tmp_path / "empty")))


def _train(tmp_path, monkeypatch, epochs: int, exp: str):
    import json

    from littlegan_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    cfg = {"model": "stylegan2", **TINY, "compute_dtype": "float32", "use_s2d": False, "device_data": True,
           "steps_per_dispatch": 4, "epoch": epochs, "freq_gen": 8, "all_result_dir": str(tmp_path / "result")}
    (tmp_path / "sample.config.json").write_text(json.dumps(cfg))
    assert main(["train", exp, "--debug", "--synthetic-data", "--device", "cpu"]) == 0
    return tmp_path / "result" / exp


def test_cli_trains_saves_and_resumes(tmp_path, monkeypatch, capsys):
    """64 synthetic images at batch 4: 16 iterations an epoch, 4 calls of K = 4."""
    import numpy as np

    from littlegan_tpu_torch.training.checkpoint import Checkpointer

    whole = _train(tmp_path, monkeypatch, 2, "whole")
    assert "iteration 32:" in capsys.readouterr().out
    assert (whole / "train" / "gen" / "1-16.jpg").is_file()
    saved = Checkpointer(str(whole / "checkpoint")).restore_flat("2")
    assert ".pl_mean" in saved and float(saved[".pl_mean"]) > 0 and ".buffers/G/mapping/w_avg" in saved
    assert int(saved[".opt_g/.count/G/synthesis/b8/torgb/bias"]) == 40
    assert int(saved[".opt_g/.count/G/synthesis/b8/conv0/weight"]) == 40
    _train(tmp_path, monkeypatch, 1, "split")
    split = _train(tmp_path, monkeypatch, 2, "split")  # restores epoch 1, trains epoch 2
    assert "Restored checkpoint 1" in capsys.readouterr().out
    b = Checkpointer(str(split / "checkpoint")).restore_flat("2")
    # the images from the seed, draws per (seed, first iteration of a call): the resumed run is the unbroken one
    assert saved.keys() == b.keys() and all(np.array_equal(saved[k], b[k]) for k in saved)


# ---------------------------------------------------------------------------
# The card


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


CARD_SHAPES = ([("conv0", (1, 1, 1, 1, 4.0), min(16384 // r, 512), 2 * r + 1) for r in (8, 64, 256)]
               + [("image", (2, 1, 2, 1, 4.0), 3, r // 2) for r in (8, 256)]
               + [("prefilter", (1, 1, 2, 2, 1.0), min(16384 // r, 512), r) for r in (256, 32, 8)]
               + [("skip", (1, 2, 1, 1, 1.0), min(16384 // r, 512), r) for r in (256, 32, 8)])
ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}  # one bf16 rounding / f32 sums in another order


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("what,form,c,h", CARD_SHAPES, ids=[f"{w}-{c}-{h}" for w, _, c, h in CARD_SHAPES])
def test_fir_kernel_equals_the_plain_version(card, dtype, what, form, c, h):
    up, down, p0, p1, gain = form
    gen = torch.Generator().manual_seed(c + h)
    oh = fir.out_size(h, up, down, p0, p1)
    for u, d, q, n_in, n_out in ((up, down, p0, h, oh), (down, up, 3 - p0, oh, h)):
        x = torch.randn((8, c, n_in, n_in), generator=gen).to(card, dtype).contiguous(memory_format=CL)
        got = fir.upfirdn2d_kernel(x, u, d, q, n_out, n_out, gain)
        want = fir.upfirdn2d_plain(x, u, d, q, n_out, n_out, gain)
        torch.cuda.synchronize(card)
        assert got.shape == want.shape and got.is_contiguous(memory_format=CL)
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        assert err <= ROUNDING[dtype], (u, d, q, err)


@pytest.mark.card
def test_fir_kernel_reads_an_nchw_map_as_its_channels_last_copy(card):
    """A gradient may arrive in NCHW memory: the kernel reads its
    channels-last copy and writes channels-last."""
    x = torch.randn((2, 16, 9, 9), device=card)
    got = fir.upfirdn2d_kernel(x, 1, 1, 1, 8, 8, 4.0)
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, fir.upfirdn2d_kernel(x.contiguous(memory_format=CL), 1, 1, 1, 8, 8, 4.0))


@pytest.mark.card
def test_iteration_on_the_kernels_equals_the_plain_versions(card, setup):
    """Two iterations (Greg and Dreg in the first) of the tiny model in
    float32 on the card, through the kernels and under ``plain_versions``:
    the same terms and parameters to float32 rounding (at a step size small
    enough that an Adam step's sign turned by a rounding stays below it)."""
    p0, images = setup
    cfg = tiny_cfg(g_reg_interval=2, d_reg_interval=2, lr=1e-6)
    gen = torch.Generator(device=card).manual_seed(8)
    images = images.to(card)
    draws = ts.stack_draws([ts.draw_iteration(gen, cfg, card, it, N_STORE) for it in range(2)])
    out = []
    for plain in (False, True):
        model = sm.StyleGAN2(cfg)
        with torch.no_grad():
            for n, prm in model.named_parameters():
                prm.copy_(p0[n])
        state = create_stylegan2_state(cfg, card, model)
        before = fir.CALLS.value
        if plain:
            with _build.plain_versions():
                terms = ts.eager_iterations(state, cfg, images, draws, 0)
        else:
            terms = ts.eager_iterations(state, cfg, images, draws, 0)
            assert fir.CALLS.value > before
        out.append((terms, {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    for n, v in out[1][1].items():
        torch.testing.assert_close(out[0][1][n], v, rtol=1e-3, atol=1e-5, msg=n)
    assert math.isfinite(float(out[0][0].sum()))
