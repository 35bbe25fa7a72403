"""The port's G, D and A against the JAX package's, with the same weights.

JAX ``init_params`` makes the weights; ``params_from_jax`` carries them into
the port's ``LittleGAN``. Inputs come from numpy. Both run in f32 on the
CPU, for s2d on and off and with the kernel flags (``use_pallas``,
``use_pallas_boundary``) on and off: the JAX side then runs its Pallas
kernels in interpret mode, the port its kernels' plain versions.
Tolerance rtol 1e-4 / atol 1e-5, as tests/test_pallas.py:75-81."""

import math

import numpy as np
import pytest
import torch

import jax

from littlegan_tpu.models import littlegan as jm
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.compat.jax_params import params_from_jax
from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.models import littlegan as tm

TOL = dict(rtol=1e-4, atol=1e-5)


def _tcfg(jcfg) -> TConfig:
    """The port's Config with the same field values as a JAX Config."""
    import dataclasses

    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _pair(jcfg, seed=0, mutate=None):
    params = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = _flatten(params)
    if mutate is not None:
        flat = mutate(flat)
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), [flat[k] for k in _flatten(params)]
        )
    tcfg = _tcfg(jcfg)
    return params, params_from_jax(flat, tm.LittleGAN(tcfg)).eval(), tcfg


def _inputs(cfg, n=3, seed=1):
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(n, cfg.noise_dim)).astype(np.float32)
    cond = np.where(rng.random((n, cfg.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32)
    image = rng.uniform(-1, 1, (n, cfg.image_dim, cfg.image_dim, cfg.image_channel)).astype(np.float32)
    return noise, cond, image


FLAGS = {
    "plain": dict(use_s2d=False, use_pallas=False, use_pallas_boundary=False),
    "s2d": dict(use_s2d=True, use_pallas=False, use_pallas_boundary=False),
    "kernels": dict(use_s2d=False, use_pallas=True, use_pallas_boundary=True),
    "s2d+kernels": dict(use_s2d=True, use_pallas=True, use_pallas_boundary=True),
}


@pytest.mark.parametrize("net", ["generator", "discriminator", "adjuster"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_networks_match_jax(tiny_cfg, flags, net):
    jcfg = tiny_cfg.replace(**FLAGS[flags])
    params, model, _ = _pair(jcfg)
    noise, cond, image = _inputs(jcfg)
    with torch.no_grad():
        if net == "generator":
            want = [jm.generator_apply(params, noise, cond, jcfg)]
            got = [model.generator(torch.from_numpy(noise), torch.from_numpy(cond))]
        elif net == "discriminator":
            want = list(jm.discriminator_apply(params, image, jcfg))
            got = list(model.discriminator(torch.from_numpy(image)))
        else:
            want = [jm.adjuster_apply(params, image, cond, jcfg)]
            got = [model.adjuster(torch.from_numpy(image), torch.from_numpy(cond))]
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **TOL)


@pytest.mark.parametrize("s2d", [False, True])
def test_cond_bias_generator_matches_jax(tiny_cfg, s2d):
    jcfg = tiny_cfg.replace(cond_bias=True, use_s2d=s2d)

    def nonzero_cond_kernel(flat):
        flat = dict(flat)
        k = "out_conv/cond_kernel"
        flat[k] = np.random.default_rng(2).normal(size=flat[k].shape).astype(np.float32) * 0.5
        return flat

    params, model, _ = _pair(jcfg, mutate=nonzero_cond_kernel)
    noise, cond, _ = _inputs(jcfg)
    want = jm.generator_apply(params, noise, cond, jcfg)
    with torch.no_grad():
        got = model.generator(torch.from_numpy(noise), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_s2d_io_modes_match_jax(tiny_cfg):
    """Block-space image in and out (s2d_in / s2d_out) as the JAX train step uses them."""
    jcfg = tiny_cfg.replace(use_s2d=True)
    params, model, _ = _pair(jcfg)
    noise, cond, image = _inputs(jcfg)
    from littlegan_tpu.ops.s2d import space_to_depth

    img_s2d = np.asarray(space_to_depth(image))
    with torch.no_grad():
        g = model.generator(torch.from_numpy(noise), torch.from_numpy(cond), s2d_out=True)
        a = model.adjuster(torch.from_numpy(img_s2d), torch.from_numpy(cond), s2d_in=True, s2d_out=True)
        d = model.discriminator(torch.from_numpy(img_s2d), s2d_in=True)
    np.testing.assert_allclose(g.numpy(), np.asarray(jm.generator_apply(params, noise, cond, jcfg, s2d_out=True)), **TOL)
    np.testing.assert_allclose(
        a.numpy(), np.asarray(jm.adjuster_apply(params, img_s2d, cond, jcfg, s2d_in=True, s2d_out=True)), **TOL
    )
    np.testing.assert_allclose(d[0].numpy(), np.asarray(jm.discriminator_apply(params, img_s2d, jcfg, s2d_in=True)[0]), **TOL)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_parameter_names_and_shapes_match_jax(tiny_cfg, full_cfg, which):
    jcfg = tiny_cfg if which == "tiny" else full_cfg
    shapes = jax.eval_shape(lambda k: jm.init_params(jcfg, k), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _flatten_shapes(shapes).items()}
    model = tm.LittleGAN(_tcfg(jcfg))
    got = {n.replace(".", "/"): tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert len(got) == 46
    assert tm.param_count(model) == sum(math.prod(s) for s in want.values())


def _flatten_shapes(tree):
    from littlegan_tpu.utils.tree import path_str

    return {path_str(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_init_params_glorot_fans_and_seed(tiny_cfg):
    cfg = _tcfg(tiny_cfg)
    a, b, c = tm.init_params(cfg, 0), tm.init_params(cfg, 0), tm.init_params(cfg, 1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["decoder.block1.conv.kernel"], sc["decoder.block1.conv.kernel"])
    # deconv kernel (kh, kw, out, in): fan_in from axis -2 (out), as the JAX init
    k = sa["decoder.block1.conv.kernel"]
    kh, kw, o, i = k.shape
    limit = math.sqrt(6.0 / (kh * kw * o + kh * kw * i))
    assert float(k.abs().max()) <= limit
    assert float(k.abs().max()) > 0.9 * limit
    assert torch.all(sa["decoder.block1.conv.bias"] == 0)
    assert torch.all(sa["encoder.block2.norm.gamma"] == 1) and torch.all(sa["encoder.block2.norm.beta"] == 0)


def test_params_from_jax_rejects_missing_and_misshapen(tiny_cfg):
    flat = _flatten(jm.init_params(tiny_cfg, jax.random.PRNGKey(0)))
    model = tm.LittleGAN(_tcfg(tiny_cfg))
    missing = {k: v for k, v in flat.items() if k != "encoder/block3/conv/kernel"}
    with pytest.raises(KeyError, match="encoder/block3/conv/kernel"):
        params_from_jax(missing, model)
    bad = dict(flat)
    bad["g_head/dense/bias"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="g_head/dense/bias"):
        params_from_jax(bad, model)
    loaded = params_from_jax(flat, model)
    np.testing.assert_array_equal(
        loaded.encoder.block1.conv.kernel.detach().numpy(), np.asarray(flat["encoder/block1/conv/kernel"])
    )
