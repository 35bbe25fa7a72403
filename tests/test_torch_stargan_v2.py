"""StarGAN v2 on the port's training path, against the plain float32
reference ``benchmark/reference/stargan_v2.py`` (plain torch, imports
nothing of the port), on the CPU at a tiny size: 32² images, widths up to
32, 3 domains, batch 4, float32 compute.

- the four networks on seeded random weights, and ``he_init``'s shapes;
- the crop, the norms, the balanced sampling and torch Adam's arithmetic;
- one iteration's 14 loss terms, and after 2 iterations through the
  K-update scan every parameter, moment and EMA against 2 eager iterations
  (bit for bit) and against the reference;
- the call counters (8 / 7 / 3 / 6 / 2 per iteration), an unchosen head
  moving under weight decay, the refused options;
- ``python -m littlegan_tpu_torch train`` over a domain-folder set, its
  checkpoint, and a resumed run equal to an unbroken one.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.data.domains import BalancedSampler, DomainFolder
from littlegan_tpu_torch.models import stargan_v2 as sm
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda.channel_norm_lrelu import channel_norm_lrelu_plain
from littlegan_tpu_torch.ops.resample import crop_resize, draw_crops
from littlegan_tpu_torch.training import stargan_v2 as ts
from littlegan_tpu_torch.training.checkpoint import Checkpointer, flatten_state
from littlegan_tpu_torch.training.optimizer import adam_init, adam_l2_update_rows, torch_adam_step
from littlegan_tpu_torch.training.state import StarGANState, create_stargan_state
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference import stargan_v2 as ref  # noqa: E402

TINY = dict(model="stargan_v2", image_dim=32, base_dim=8, max_conv_dim=32, mapping_dim=32, style_dim=16,
            latent_dim=8, num_domains=3, batch_size=4, compute_dtype="float32", use_s2d=False, leaky_alpha=0.2,
            lr=1e-3, f_lr=1e-4, beta_1=0.0, beta_2=0.99, weight_decay=1e-4, ema_decay=0.9, lambda_ds=2.0,
            ds_iter=10, device_data=True)
REF_KEYS = ("image_dim", "num_domains", "latent_dim", "style_dim", "mapping_dim", "max_conv_dim", "base_dim",
            "leaky_alpha", "lr", "f_lr", "beta_1", "beta_2", "weight_decay", "lambda_reg", "lambda_sty", "lambda_ds",
            "lambda_cyc", "ds_iter", "ema_decay")
B, N_STORE = 4, 24


def tiny_cfg(**kw) -> Config:
    return Config(**{**TINY, **kw})


def ref_dict(cfg: Config) -> dict:
    return {k: getattr(cfg, k) for k in REF_KEYS}


@pytest.fixture(scope="module")
def setup():
    """(cfg, reference weights, store images, labels, ids (2, 3B), draws of 2 iterations)."""
    cfg = tiny_cfg()
    gen = torch.Generator().manual_seed(20260)
    p0 = ref.init_params(ref.Model.from_config(ref_dict(cfg)).shapes(), gen, "cpu")
    images = torch.randint(0, 256, (N_STORE, 32, 32, 3), dtype=torch.uint8, generator=gen)
    labels = torch.arange(N_STORE) % 3
    sampler = BalancedSampler(labels.numpy(), 3)
    rng = np.random.default_rng(7)
    ids = np.stack([sampler.draw(rng, B) for _ in range(2)])
    dgen = torch.Generator().manual_seed(11)
    draws = ts.stack_draws([ts.draw_iteration(dgen, cfg, "cpu") for _ in range(2)])
    return cfg, p0, images, labels, ids, draws


def port_state(cfg: Config, p0) -> StarGANState:
    model = sm.StarGANv2(cfg)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            prm.copy_(p0[name])
    return create_stargan_state(cfg, "cpu", model)


def reference_iterations(cfg: Config, p0, images, labels, ids, draws, k: int):
    """((k, 14) losses, parameters, Adams, EMA, first-gradient norms) of the reference's k iterations."""
    model, hp = ref.Model.from_config(ref_dict(cfg)), ref.Hyper.from_config(ref_dict(cfg))
    p = ref.leaves(p0)
    opts, ema, norms = ref.adams(p, hp), ref.new_ema(p), {}
    losses = []
    for i in range(k):
        batch = ref.take(images, labels, torch.as_tensor(ids[i]), draws.boxes[i], draws.flips[i], B)
        losses.append(ref.iteration(model, p, opts, ema, batch, {"z": draws.z[i], "z2": draws.z2[i]}, i, hp,
                                    grad_norms=norms if i == 0 else None))
    return torch.stack(losses), p, opts, ema, norms


def test_parameters_match_the_reference_shapes_and_he_init():
    cfg = tiny_cfg()
    model = sm.init_params(sm.StarGANv2(cfg), 3)
    shapes = ref.Model.from_config(ref_dict(cfg)).shapes()
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == list(shapes.items())
    prm = dict(model.named_parameters())
    w = prm["discriminator.main.1.conv1.weight"].detach()
    # he_init: N(0, 2 / fan_in); 8 * 8 * 9 = 576 draws, so the std is within 10% (about 3.4 standard errors)
    assert abs(float(w.std()) / (2.0 / 72) ** 0.5 - 1) < 0.1
    assert float(prm["generator.encode.0.norm1.weight"].detach().min()) == 1.0
    assert float(prm["generator.from_rgb.bias"].detach().abs().max()) == 0.0


def test_published_sizes_at_256():
    """The AFHQ configuration's parameter counts (the published modules' own)."""
    model = sm.StarGANv2(tiny_cfg(image_dim=256, base_dim=0, max_conv_dim=512, mapping_dim=512, style_dim=64,
                                  latent_dim=16))
    counts = {net: sum(p.numel() for p in getattr(model, net).parameters()) for net in ("generator", "mapping_network", "style_encoder", "discriminator")}
    assert counts == {"generator": 33892995, "mapping_network": 3259072, "style_encoder": 20949760,
                      "discriminator": 20852803}


def test_networks_match_the_reference(setup):
    cfg, p0, *_ = setup
    model = port_state(cfg, p0).model
    rm = ref.Model.from_config(ref_dict(cfg))
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((B, 3, 32, 32), generator=gen) * 2 - 1
    s, z = torch.randn((B, 16), generator=gen), torch.randn((B, 8), generator=gen)
    y = torch.tensor([0, 2, 1, 2])
    pairs = [(model.generator(x, s), rm.generator(p0, x, s)), (model.mapping_network(z, y), rm.mapping(p0, z, y)),
             (model.style_encoder(x, y), rm.style_encoder(p0, x, y)),
             (model.discriminator(x, y), rm.discriminator(p0, x, y))]
    for got, want in pairs:
        # float32: the norms' batch_norm kernel and the reference's mean/variance formula differ by
        # rounding only (measured 5e-6 of outputs of order 1)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_norms_are_instance_norm_and_adain():
    """The norm kernel's plain version at slope 1 (no LeakyReLU) is IN with
    a shared (C,) affine, and AdaIN with a per-sample (B, C) one."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((3, 5, 6, 6), generator=gen) * 3 + 1
    w, b = torch.rand(5, generator=gen), torch.randn(5, generator=gen)
    # equal up to the reductions' order (torch.instance_norm takes Welford moments)
    torch.testing.assert_close(channel_norm_lrelu_plain(x, w, b, 0.0, 1.0, 1e-5)[0],
                               F.instance_norm(x, weight=w, bias=b), rtol=1e-5, atol=1e-5)
    g, be = torch.randn((3, 5), generator=gen), torch.randn((3, 5), generator=gen)
    want = (1 + g[:, :, None, None]) * F.instance_norm(x) + be[:, :, None, None]
    torch.testing.assert_close(channel_norm_lrelu_plain(x, g, be, 1.0, 1.0, 1e-5)[0], want, rtol=1e-5, atol=1e-5)


def test_crop_boxes_and_resize():
    gen = torch.Generator().manual_seed(9)
    boxes, flips = draw_crops(gen, 4096, 256, 0.5, "cpu")
    top, left, h, w = boxes.unbind(1)
    assert bool(((top >= 0) & (left >= 0) & (top + h <= 256) & (left + w <= 256)).all())
    cut = (h < 256) | (w < 256)
    area = (h * w)[cut] / 256 ** 2
    ratio = (w / h)[cut]
    # RandomResizedCrop's ranges, widened by the rounding of w and h to whole pixels
    assert float(area.min()) > 0.79 and float(ratio.min()) > 0.89 and float(ratio.max()) < 1.11
    # half the boxes cut (p 0.5; some cut boxes round to the whole image), half the images flipped:
    # 4096 draws put each share within 0.05 of 0.5 by more than 6 standard errors
    assert abs(float(cut.float().mean()) - 0.5) < 0.05 and abs(float(flips.float().mean()) - 0.5) < 0.05
    img = torch.randint(0, 256, (3, 16, 16, 3), dtype=torch.uint8, generator=gen)
    whole = torch.tensor([[0.0, 0.0, 16.0, 16.0]] * 3)
    x = img.permute(0, 3, 1, 2).float() / 127.5 - 1
    # a whole-image box samples every pixel at its centre: the image itself, and mirrored with a flip
    torch.testing.assert_close(crop_resize(img, whole, torch.zeros(3, dtype=torch.bool)), x, rtol=0, atol=1e-5)
    torch.testing.assert_close(crop_resize(img, whole, torch.ones(3, dtype=torch.bool)), x.flip(3), rtol=0,
                               atol=1e-5)
    small = torch.tensor([[2.0, 3.0, 14.0, 13.0], [0.0, 1.0, 15.0, 15.0], [1.0, 0.0, 13.0, 14.0]])
    fl = torch.tensor([True, False, True])
    # the port's and the reference's theta differ in how they are assembled only
    torch.testing.assert_close(crop_resize(img, small, fl), ref.crop_resize(img, small, fl), rtol=0, atol=1e-5)


def test_balanced_sampler_pairs_are_distinct_and_of_one_domain():
    labels = np.array([0] * 50 + [1] * 5 + [2] * 20)
    sampler = BalancedSampler(labels, 3)
    rng = np.random.default_rng(0)
    ids = np.stack([sampler.draw(rng, 8) for _ in range(600)])
    src, r1, r2 = ids[:, :8], ids[:, 8:16], ids[:, 16:]
    assert (r1 != r2).all() and (labels[r1] == labels[r2]).all()
    # domains uniform whatever their sizes: 4,800 draws each put a share within 0.04 of 1/3 (over 5 s.e.)
    for part in (src, r1):
        shares = np.bincount(labels[part].ravel(), minlength=3) / part.size
        assert np.abs(shares - 1 / 3).max() < 0.04
    with pytest.raises(ValueError, match="two images"):
        BalancedSampler(np.array([0, 0, 1]), 2)


def test_adam_rows_equal_torch_optim_adam():
    gen = torch.Generator().manual_seed(4)
    params = {"a": torch.randn((7, 5), generator=gen), "b": torch.randn(3, generator=gen)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=1e-3, betas=(0.0, 0.99), weight_decay=1e-4)
    state = adam_init(params)
    for i in range(4):
        grads = {k: torch.randn(v.shape, generator=gen) * 10 ** -i for k, v in params.items()}
        for k, v in leaves.items():
            v.grad = grads[k].clone()
        opt.step()
        ss, bc = torch_adam_step(state, 1e-3, 0.0, 0.99)
        adam_l2_update_rows(grads, state, params, torch.tensor(ss), torch.tensor(bc), 0.0, 0.99, 1e-4)
    for k, v in leaves.items():  # the same float32 operations in the same order: bit for bit
        assert torch.equal(params[k], v.detach())
        assert torch.equal(state.nu[k], opt.state[v]["exp_avg_sq"])
    assert state.count == {"a": 4, "b": 4}


def test_schedule_rows_and_lambda_ds():
    cfg = tiny_cfg()
    state = create_stargan_state(cfg, "cpu")
    rows = ts.schedule_rows(state, cfg, [0, 5, 10, 12], advance=False)
    assert rows.shape == (4, ts.ROW_WIDTH) and all(c == 0 for c in state.opt_d.count.values())
    np.testing.assert_allclose(rows[:, -1], [2.0, 1.0, 0.0, 0.0])
    rows = ts.schedule_rows(state, cfg, [0, 1])
    # D steps twice an iteration, G twice, F and E once: counts 4 / 4 / 2 / 2
    assert [next(iter(getattr(state, o).count.values())) for o in ("opt_d", "opt_g", "opt_f", "opt_e")] == [4, 4, 2, 2]
    np.testing.assert_allclose(rows[0, 1], np.sqrt(1 - 0.99), rtol=1e-6)  # D's first step: t = 1
    np.testing.assert_allclose(rows[0, 3], np.sqrt(1 - 0.99 ** 2), rtol=1e-6)  # D's second: t = 2
    np.testing.assert_allclose(rows[0, 6], 1e-4, rtol=1e-6)  # F's step size is f_lr (beta_1 0: no correction)


def test_iteration_losses_and_two_scanned_iterations_match(setup):
    cfg, p0, images, labels, ids, draws = setup
    scanned = port_state(cfg, p0)
    before = _build.launch_counts()
    got = ts.make_stargan_scan_step(cfg, scanned, 2)(scanned, images, labels, ids, draws, 0)
    after = _build.launch_counts()
    calls = {n: after[f"stargan_v2.{n}"] - before.get(f"stargan_v2.{n}", 0)
             for n in ("generator", "style_encoder", "mapping", "discriminator", "r1")}
    assert calls == {"generator": 16, "style_encoder": 14, "mapping": 6, "discriminator": 12, "r1": 4}
    eager = port_state(cfg, p0)
    want = ts.eager_iterations(eager, cfg, images, labels, ids, draws, 0)
    # the scan body on a CPU state is the same calls in the same order: bit for bit
    assert torch.equal(got, want)
    fa, fb = flatten_state(scanned), flatten_state(eager)
    assert fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)

    ref_losses, p, opts, ema, norms = reference_iterations(cfg, p0, images, labels, ids, draws, 2)
    # the 14 terms of both iterations: float32 in both, different reduction orders (measured 4e-7 relative)
    torch.testing.assert_close(got, ref_losses, rtol=1e-4, atol=1e-6)
    assert float(got[0, 2]) > 0 and float(got[0, 8]) > 0  # R1 and the diversity term are live
    med = float(np.median(list(norms.values())))
    prm = dict(scanned.model.named_parameters())
    for opt, net in (("opt_g", "generator"), ("opt_f", "mapping_network"), ("opt_e", "style_encoder"),
                     ("opt_d", "discriminator")):
        lr = cfg.f_lr if net == "mapping_network" else cfg.lr
        steps = {"opt_g": 4, "opt_d": 4, "opt_f": 2, "opt_e": 2}[opt]
        for k, m in getattr(scanned, opt).mu.items():
            dp, dr = prm[k].detach() - p0[k], p[k].detach() - p0[k]
            # Adam moves an element at most 1.42 lr a step here (beta_1 0, beta_2 0.99); where an element's
            # gradient is rounding noise (the biases ahead of an instance norm) its sign can differ
            assert float((dp - dr).abs().max()) <= 2 * 1.42 * lr * steps + 1e-7, k
            mr, vr = opts[net].state[p[k]]["exp_avg"], opts[net].state[p[k]]["exp_avg_sq"]
            if norms[k] < 1e-3 * med:
                # the gradient is rounding noise in both (a bias ahead of an instance norm): so are the moments
                assert max(float(torch.linalg.vector_norm(m)), float(torch.linalg.vector_norm(mr))) < 1e-3 * med, k
                continue
            # a live gradient: the change agrees to 0.1% of its norm (measured under 1e-5)
            assert float(torch.linalg.vector_norm(dp - dr)) <= 1e-3 * float(torch.linalg.vector_norm(dr)), k
            # the moments hold the last gradient (beta_1 0) and its running square: to 1e-4 of the largest
            assert float((m - mr).abs().max()) <= 1e-4 * float(mr.abs().max()), k
            assert float((getattr(scanned, opt).nu[k] - vr).abs().max()) <= 1e-4 * float(vr.abs().max()), k
    # the EMA, held as the parameters are: from e0 = p0, e2 - p0 = beta (1 - beta) (p1 - p0) + (1 - beta) (p2 - p0)
    _, p1, *_ = reference_iterations(cfg, p0, images, labels, ids, draws, 1)
    beta = cfg.ema_decay
    live = 0
    for k, e in scanned.ema.items():
        net = k.split(".", 1)[0]
        lr, steps = (cfg.f_lr, 2) if net == "mapping_network" else (cfg.lr, 4 if net == "generator" else 2)
        de, dr = e - p0[k], ema[k] - p0[k]
        if norms[k] < 1e-3 * med:
            # rounding noise moves the parameter by up to 2 * 1.42 lr a step (above); the EMA by
            # (1 - beta)(1 + beta) = 0.19 of that
            assert float((de - dr).abs().max()) <= 0.19 * (2 * 1.42 * lr * steps) + 1e-7, k
            continue
        live += 1
        gap = lambda d: float(torch.linalg.vector_norm(d - dr)) / float(torch.linalg.vector_norm(dr))  # noqa: E731
        # a live gradient: the EMA's change agrees to 0.1% of its norm, as the parameters' does
        assert gap(de) <= 1e-3, k
        # and that bound sees a wrong EMA: one left at its start, one of decay 0.99, one of decay 0.1 (the
        # lerp's ends swapped), and the parameters themselves (decay 0) each miss it by over 10 times
        q1, q2 = p1[k].detach() - p0[k], p[k].detach() - p0[k]
        wrong = [torch.zeros_like(dr), q2] + [b * (1 - b) * q1 + (1 - b) * q2 for b in (0.99, 1 - beta)]
        assert min(gap(w) for w in wrong) > 1e-2, k
    assert live > len(scanned.ema) // 2


def test_an_unchosen_head_moves_under_weight_decay(setup):
    """No sample takes domain 2: its heads get a zero gradient, and Adam
    still moves them by the L2 term, as torch.optim.Adam does."""
    cfg, p0, images, labels, _, draws = setup
    ids = np.array([[0, 1, 3, 4, 6, 7, 9, 10, 3, 4, 0, 1]])  # labels 0 and 1 only (label = id % 3)
    state = port_state(cfg, p0)
    ts.eager_iterations(state, cfg, images, labels, ids, ts.StarGANDraws(*(x[:1] for x in draws)), 0)
    _, p, *_ = reference_iterations(cfg, p0, images, labels, ids, ts.StarGANDraws(*(x[:1] for x in draws)), 1)
    prm = dict(state.model.named_parameters())
    for k in ("mapping_network.unshared.2.6.weight", "style_encoder.unshared.2.weight"):
        moved = prm[k].detach() - p0[k]
        # g = weight_decay * p alone: Adam's first step is lr * g / (|g| + eps) toward 0 (F's lr is f_lr)
        lr = cfg.f_lr if k.startswith("mapping") else cfg.lr
        g = cfg.weight_decay * p0[k]
        # (the moved amount carries the float32 rounding of weights of order 1: 1e-7)
        torch.testing.assert_close(moved, -lr * g / (g.abs() + 1e-8), rtol=1e-4, atol=1e-7)
        # one float32 rounding apart at most: torch.optim.Adam's addcdiv against the row form's div, mul, sub
        torch.testing.assert_close(prm[k].detach(), p[k].detach(), rtol=2.4e-7, atol=1e-9)
    row = prm["discriminator.main.7.weight"].detach()[2] - p0["discriminator.main.7.weight"][2]
    assert float(row.abs().min()) > 0  # D's unchosen logit row moves too (two steps)


@pytest.mark.parametrize("flags", [dict(use_pallas=True), dict(use_pallas_boundary=True)],
                         ids=lambda d: next(iter(d)))
def test_kernel_flags_do_not_reach_the_model(setup, flags):
    """The JAX package's kernel flags are ignored: the four networks built
    with one set give the outputs of the same networks without it."""
    cfg, p0, *_ = setup
    model, flagged = port_state(cfg, p0).model, port_state(tiny_cfg(**flags), p0).model
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((B, 3, 32, 32), generator=gen) * 2 - 1
    s, z = torch.randn((B, 16), generator=gen), torch.randn((B, 8), generator=gen)
    y = torch.tensor([1, 0, 2, 1])
    for m in (model, flagged):
        m.requires_grad_(False)
    for net, args in (("generator", (x, s)), ("mapping_network", (z, y)), ("style_encoder", (x, y)),
                      ("discriminator", (x, y))):
        assert torch.equal(getattr(flagged, net)(*args), getattr(model, net)(*args)), net


@pytest.mark.parametrize("flag", [dict(use_s2d=True),
                                  dict(use_gp=True), dict(remat=True), dict(mesh_shape=[1, 2]),
                                  dict(shard_opt_state=True), dict(grad_accum=2)],
                         ids=lambda d: next(iter(d)))
def test_refused_options(flag):
    name = next(iter(flag))
    with pytest.raises(ValueError, match={"mesh_shape": "a mesh", "shard_opt_state": "sharding"}.get(name, name)):
        sm.StarGANv2(tiny_cfg(**flag))


def test_littlegan_stays_the_default_and_other_models_are_refused():
    from littlegan_tpu_torch.training.trainer import Trainer, make_trainer

    assert Config().model == "littlegan"
    with pytest.raises(ValueError, match="model must be one of"):
        make_trainer(Config(model="stylegan"), None, device="cpu")
    with pytest.raises(ValueError, match="Trainer trains LittleGAN"):
        Trainer(tiny_cfg(), None, device="cpu")


def _domain_set(root, n_per=(4, 3, 3)):
    from PIL import Image

    rng = np.random.default_rng(0)
    for name, n in zip(("cat", "dog", "wild"), n_per):
        os.makedirs(root / name)
        for i in range(n):
            size = 40 if i % 2 else 32  # one size is resized on load
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(root / name / f"{i}.png")


def test_domain_folder_loads_labels_by_sorted_folder(tmp_path):
    _domain_set(tmp_path / "set")
    data = DomainFolder(tiny_cfg(image_path=str(tmp_path / "set")))
    images, labels = data.load()
    assert data.label == ["cat", "dog", "wild"] and images.shape == (10, 32, 32, 3) and images.dtype == np.uint8
    assert labels.tolist() == [0] * 4 + [1] * 3 + [2] * 3
    with pytest.raises(ValueError, match="num_domains"):
        DomainFolder(tiny_cfg(image_path=str(tmp_path / "set"), num_domains=2))


def _train(tmp_path, monkeypatch, epochs: int, exp: str):
    import json

    from littlegan_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    cfg = {k: v for k, v in TINY.items()}
    cfg.update(image_path=str(tmp_path / "set"), epoch=epochs, steps_per_dispatch=2, freq_gen=2,
               all_result_dir=str(tmp_path / "result"), test_data_dir=str(tmp_path / "test-data"))
    (tmp_path / "sample.config.json").write_text(json.dumps(cfg))
    assert main(["train", exp, "--debug", "--device", "cpu"]) == 0
    return tmp_path / "result" / exp


def test_cli_trains_from_a_domain_folder_and_resumes(tmp_path, monkeypatch, capsys):
    _domain_set(tmp_path / "set", (3, 3, 3))  # 9 images, batch 4: 2 iterations an epoch
    whole = _train(tmp_path, monkeypatch, 2, "whole")
    out = capsys.readouterr().out
    assert "device_data: uploading" in out and "iteration 4:" in out
    assert {f for f in os.listdir(whole / "train" / "gen")} == {"1-2.jpg", "2-4.jpg"}
    ckpt = Checkpointer(str(whole / "checkpoint"))
    assert ckpt.epoch_tags() == [1, 2]
    state = create_stargan_state(tiny_cfg(), "cpu")
    ckpt.restore("2", state)  # the round trip: every array of the file back in a fresh state
    saved = ckpt.restore_flat("2")
    flat = flatten_state(state)
    assert flat.keys() == saved.keys() and all(np.array_equal(flat[k], saved[k]) for k in flat)
    assert int(saved[".opt_d/.count/discriminator/main/0/weight"]) == 8 and ".ema/generator/from_rgb/weight" in saved

    _train(tmp_path, monkeypatch, 1, "split")
    split = _train(tmp_path, monkeypatch, 2, "split")  # restores epoch 1, trains epoch 2
    assert "Restored checkpoint 1" in capsys.readouterr().out
    a, b = (Checkpointer(str(run / "checkpoint")).restore_flat("2") for run in (whole, split))
    # ids per (seed, epoch), draws per (seed, iteration): the resumed run is the unbroken one, bit for bit
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_other_modes_refuse_stargan_v2(tmp_path, monkeypatch, capsys):
    import json

    from littlegan_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "sample.config.json").write_text(json.dumps(TINY))
    for mode in ("plot", "random-sample", "serve", "export-model"):
        assert main([mode, "x", "--device", "cpu"]) == 2
    assert "runs only in train mode" in capsys.readouterr().err


def test_config_fields_are_the_published_defaults():
    cfg = Config()
    got = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name in (
        "num_domains", "latent_dim", "style_dim", "mapping_dim", "max_conv_dim", "lambda_reg", "lambda_sty",
        "lambda_ds", "lambda_cyc", "ds_iter", "f_lr", "weight_decay", "randcrop_prob")}
    assert got == dict(num_domains=2, latent_dim=16, style_dim=64, mapping_dim=512, max_conv_dim=512, lambda_reg=1.0,
                       lambda_sty=1.0, lambda_ds=1.0, lambda_cyc=1.0, ds_iter=100000, f_lr=1e-6, weight_decay=1e-4,
                       randcrop_prob=0.5)


def test_discriminator_ops_differentiate_twice():
    """R1Conv (the bias-free conv, then the epilogue adding the bias), the
    R1 LeakyReLU and the downsample against finite differences, first and
    second order, in float64."""
    from littlegan_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue
    from littlegan_tpu_torch.ops.resample import downsample

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 6, 6), generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn((4, 3, 3, 3), generator=gen, dtype=torch.float64, requires_grad=True)
    b = torch.randn(4, generator=gen, dtype=torch.float64, requires_grad=True)

    def f(x, w, b):
        return downsample(sm.r1_leaky_relu(conv_epilogue(sm._R1Conv.apply(x, w, 1), b), 0.2))

    assert torch.autograd.gradcheck(f, (x, w, b)) and torch.autograd.gradgradcheck(f, (x, w, b))
    torch.testing.assert_close(f(x, w, b), F.avg_pool2d(F.leaky_relu(F.conv2d(x, w, b, padding=1), 0.2), 2))
