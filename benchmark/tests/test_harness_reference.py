"""The plain float32 reference against the program's plain (CPU) path, at
a small size: one train update, and one call per served endpoint."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import littlegan as ref
from conftest import TINY

LOSS_KEYS = {"gen": "loss/gen", "disc": "loss/disc", "adj": "loss/adj"}


def _setup(seed=0):
    from littlegan_tpu_torch.compat.jax_params import params_from_jax
    from littlegan_tpu_torch.models.littlegan import LittleGAN

    from benchmark.drivers.train_graph import port_config

    cfg = dict(TINY)
    pcfg = port_config(cfg)
    gen = torch.Generator().manual_seed(seed)
    p0 = ref.init_params(ref.Model.from_config(cfg).shapes(), gen, "cpu")
    model = params_from_jax({k: v.numpy() for k, v in p0.items()}, LittleGAN(pcfg))
    return cfg, pcfg, gen, p0, model


def test_one_update_matches_the_program():
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import draw_step, micro_grads, train_step

    from benchmark.drivers.train_graph import draws_at, make_store

    cfg, pcfg, gen, p0, model = _setup()
    state = create_train_state(pcfg, "cpu", model)
    images, conds = make_store(2, cfg, gen, "cpu")
    draws = draw_step(gen, pcfg, cfg["batch_size"], "cpu")
    b1, b2 = (images[0], conds[0]), (images[1], conds[1])
    port_grads, _ = micro_grads(state, b1, b2, draws, pcfg)
    out = train_step(state, b1, b2, draws, 11, pcfg)

    p = {k: v.clone() for k, v in p0.items()}
    stacked = type(draws)(draws.noise[None], type(draws.augment)(*(t[None] for t in draws.augment)))
    losses, grads = ref.train_update(ref.Model.from_config(cfg), p, ref.Adam(p), (*b1, *b2), draws_at(stacked, 0), 11,
                                     ref.Hyper.from_config(cfg))
    for name, key in LOSS_KEYS.items():
        assert losses[name] == pytest.approx(float(out.metrics[key]), rel=1e-5)
    med = float(np.median([float(g.norm()) for g in grads.values()]))
    for n, param in state.model.named_parameters():
        k = n.replace(".", "/")
        g = port_grads[n].clamp(-0.5, 0.5) if k.startswith(("encoder/", "d_head/")) else port_grads[n]
        torch.testing.assert_close(grads[k], g, rtol=1e-4, atol=1e-6)
        if float(grads[k].norm()) < 1e-3 * med:
            continue  # a gradient nought to rounding: Adam's step is eps-bound, as the cells' check leaves it out
        moved_ref, moved_port = (p[k] - p0[k]).norm(), (param.detach() - p0[k]).norm()
        assert float(abs(moved_ref - moved_port)) <= 1e-3 * float(moved_ref) + 1e-9, k


@pytest.mark.parametrize("endpoint", ["generate", "adjust", "discriminate"])
def test_one_call_per_endpoint_matches_the_engine(endpoint):
    from littlegan_tpu_torch.serving import InferenceEngine

    cfg, pcfg, gen, p0, _ = _setup(1)
    engine = InferenceEngine(pcfg.replace(restore=False), params={k: v.numpy() for k, v in p0.items()},
                             batch_size=4, device="cpu")
    model = ref.Model.from_config(cfg)
    rng = np.random.default_rng(2)
    d = cfg["image_dim"]
    image = (rng.integers(0, 256, (3, d, d, 3)).astype(np.float32) / 127.5 - 1.0)
    cond = np.where(rng.random((3, 7)) < 0.5, 0.98, -0.94).astype(np.float32)
    with torch.no_grad():
        if endpoint == "generate":
            noise = rng.standard_normal((3, cfg["noise_dim"])).astype(np.float32)
            got, want = engine.generate(cond, noise), model.generator(p0, torch.from_numpy(noise), torch.from_numpy(cond))
        elif endpoint == "adjust":
            got, want = engine.adjust(image, cond), model.adjuster(p0, torch.from_numpy(image), torch.from_numpy(cond))
        else:
            d_out = engine.discriminate(image)
            pr, c = model.discriminator(p0, torch.from_numpy(image))
            got, want = np.concatenate([d_out["pr"], d_out["cond"]], 1), torch.cat([pr, c], 1)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)


def test_fp8_control_is_coarser_than_float32():
    cfg, _, gen, p0, _ = _setup(3)
    noise = torch.randn((4, cfg["noise_dim"]), generator=gen)
    cond = torch.full((4, 7), 0.98)
    with torch.no_grad():
        exact = ref.Model.from_config(cfg).generator(p0, noise, cond)
        fp8 = ref.Model.from_config(cfg, ref.Precision("fp8")).generator(p0, noise, cond)
    assert float((fp8 - exact).abs().max()) > 1e-2
