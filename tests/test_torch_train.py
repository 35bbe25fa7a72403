"""The port's training math against the JAX package's, on the CPU in f32.

Losses, augmentation, the partition schedule, masked Adam, and the
encoder's gradients through the kernel Functions (the train step itself:
tests/test_torch_step.py). Torch cannot reproduce ``jax.random``, so a test
draws with JAX from the JAX function's key, in its split order, and hands
the draws to the port. Weights come from JAX ``init_params`` through
``params_from_jax``.

Tolerances: losses and augmentation rtol 1e-5 / atol 1e-6 (same math, f32);
encoder grads with both kernel flags rtol 1e-3 / atol 1e-5
(tests/test_pallas.py:169-172); Adam on equal gradients: weights rtol 1e-6
(atol 2e-7 with bf16 moments), f32 moments exactly, bf16 moments two of
their ulps; one f32 update bit for bit but for ``ADAM_BIT_MISSES`` weights.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.models import littlegan as jm
from littlegan_tpu.ops import losses as jlosses
from littlegan_tpu.training import optimizer as jopt
from littlegan_tpu.training import partition as jpart
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.compat.jax_params import params_from_jax
from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.models import littlegan as tm
from littlegan_tpu_torch.ops import augment as taug
from littlegan_tpu_torch.ops import losses as tlosses
from littlegan_tpu_torch.training import optimizer as topt
from littlegan_tpu_torch.training import partition as tpart
from littlegan_tpu_torch.training import step as tstep
from littlegan_tpu_torch.training.state import create_train_state
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

jaug = importlib.import_module("littlegan_tpu.ops.augment")  # the package re-exports a function of that name

EXACT = dict(rtol=1e-5, atol=1e-6)


def tcfg_of(jcfg) -> TConfig:
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_aug_draws(key, shape) -> taug.AugmentDraws:
    """The draws of ``augment``/``augment_s2d``(key, x) for a raw image
    shape, in the JAX functions' split order."""
    k_flip, k_bright, k_contrast, k_hue, k_noise = jax.random.split(key, 5)
    n = shape[0]
    return taug.AugmentDraws(
        flip=t(jax.random.bernoulli(k_flip, 0.5, (n, 1, 1, 1)).reshape(n)),
        delta_b=t(jax.random.uniform(k_bright, (), minval=-0.02, maxval=0.02)),
        factor=t(jax.random.uniform(k_contrast, (), minval=0.75, maxval=1.003)),
        delta_h=t(jax.random.uniform(k_hue, (), minval=-0.03, maxval=0.03)),
        noise=t(jax.random.normal(k_noise, tuple(shape))),
    )


def jax_step_draws(rng, cfg, img_shape) -> tstep.StepDraws:
    """``_micro_grads``' draws: split(rng, 3) -> noise, augment, and with
    ``use_gp`` the penalty's mix (``gradient_penalty``'s uniform)."""
    k_noise, k_aug, k_gp = jax.random.split(rng, 3)
    noise = t(jax.random.normal(k_noise, (img_shape[0], cfg.noise_dim), jnp.float32))
    eps = t(jax.random.uniform(k_gp, (img_shape[0], 1, 1, 1))) if cfg.use_gp else None
    return tstep.StepDraws(noise, jax_aug_draws(k_aug, img_shape), eps)


def batch(rng, cfg, n=None):
    n = n or cfg.batch_size
    img = rng.uniform(-1, 1, (n, cfg.image_dim, cfg.image_dim, cfg.image_channel)).astype(np.float32)
    cond = np.where(rng.random((n, cfg.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32)
    return img, cond


def port_state(jstate, jcfg):
    """A port TrainState holding a JAX state's weights (fresh moments)."""
    tc = tcfg_of(jcfg)
    model = params_from_jax(_flatten(jstate.params), tm.LittleGAN(tc))
    return create_train_state(tc, "cpu", model), tc


# ------------------------------------------------------------------ losses --


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    n, c = 5, 7
    cond = np.where(rng.random((n, c)) < 0.5, 0.98, -0.94).astype(np.float32)
    probs = [rng.uniform(0, 1, s).astype(np.float32) for s in ((n, c), (n, 1), (n, 1), (n, c), (n, 1))]
    probs[1][0, 0] = 0.0  # the clip at 1e-7
    probs[2][1, 0] = 1.0
    img_a, img_b = (rng.uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32) for _ in range(2))
    want = jlosses.discriminator_loss(cond, probs[0], probs[1], probs[2])
    got = tlosses.discriminator_loss(t(cond), t(probs[0]), t(probs[1]), t(probs[2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    want = jlosses.generator_loss(cond, probs[3], probs[4], img_a, img_b, 0.02)
    got = tlosses.generator_loss(t(cond), t(probs[3]), t(probs[4]), t(img_a), t(img_b), 0.02)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    np.testing.assert_allclose(
        tlosses.binary_crossentropy(t(cond), t(probs[0])).numpy(),
        np.asarray(jlosses.binary_crossentropy(cond, probs[0])), **EXACT,
    )
    np.testing.assert_allclose(
        tlosses.mean_squared_error(0.98, t(probs[1])).numpy(),
        np.asarray(jlosses.mean_squared_error(0.98, probs[1])), **EXACT,
    )


# ---------------------------------------------------------------- augment --


@pytest.mark.parametrize("delta", [-0.03, 0.0, 0.011, 0.5])
def test_adjust_hue_matches_jax(delta):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 6, 6, 3)).astype(np.float32)
    x[0, 0, 0] = [0.5, 0.5, 0.5]  # grey: c == 0
    x[0, 0, 1] = [0.7, 0.7, 0.1]  # v == r == g: the r branch wins
    x[0, 0, 2] = [0.1, 0.7, 0.7]  # v == g == b: the g branch wins
    want = jaug.adjust_hue(x, jnp.float32(delta))
    got = taug.adjust_hue(t(x), torch.tensor(delta, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_matches_jax_with_its_draws(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed + 10)
    want = jaug.augment(key, x)
    got = taug.augment(t(x), jax_aug_draws(key, x.shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


def test_augment_s2d_matches_jax_with_its_draws():
    from littlegan_tpu.ops.s2d import space_to_depth

    x = np.random.default_rng(4).uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    xs = np.asarray(space_to_depth(x))
    key = jax.random.PRNGKey(5)
    want = jaug.augment_s2d(key, xs)
    draws = jax_aug_draws(key, x.shape)
    got = taug.augment_s2d(t(xs), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    # the same pixels as the raw-layout chain
    np.testing.assert_allclose(got.numpy(), np.asarray(space_to_depth(taug.augment(t(x), draws).numpy())), **EXACT)


def test_draw_augment_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = taug.draw_augment(g, 64, (64, 4, 4, 3), "cpu")
    assert d.flip.shape == (64,) and d.flip.dtype == torch.bool and 0 < int(d.flip.sum()) < 64
    assert -0.02 <= float(d.delta_b) <= 0.02 and 0.75 <= float(d.factor) <= 1.003
    assert -0.03 <= float(d.delta_h) <= 0.03 and d.noise.shape == (64, 4, 4, 3)
    again = taug.draw_augment(torch.Generator().manual_seed(0), 64, (64, 4, 4, 3), "cpu")
    assert torch.equal(d.noise, again.noise) and torch.equal(d.flip, again.flip)


# -------------------------------------------------- partition and Adam ----


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return jm.init_params(tiny_cfg, jax.random.PRNGKey(0))


def _model_names(jparams, keys):
    return [k.replace("/", ".") for k in _flatten({k: jparams[k] for k in keys})]


@pytest.mark.parametrize("which", ["generator", "discriminator", "adjuster"])
def test_resolve_mask_matches_jax_over_two_periods(jparams, which):
    jmasks = jpart.build_partition_masks(jparams)[which]
    tmasks = tpart.build_partition_masks(
        _model_names(jparams, jm.GENERATOR_SUBTREES), _model_names(jparams, jm.DISCRIMINATOR_SUBTREES),
        _model_names(jparams, jm.ADJUSTER_TRAINABLE),
    )[which]
    for use_partition in (True, False):
        for batch_no in range(0, 31):
            want = _flatten(jpart.resolve_mask(jmasks, jnp.int32(batch_no), use_partition, 4))
            got = tpart.resolve_mask(tmasks, batch_no, use_partition, 4)
            assert {k.replace("/", "."): float(v) for k, v in want.items()} == got, (batch_no, use_partition)


@pytest.mark.parametrize("kind,warm,decay,floor", [("linear", 3, 10, 0.1), ("cosine", 0, 8, 0.2),
                                                   ("exponential", 2, 6, 0.05), ("constant", 4, 0, 0.0)])
def test_lr_scale_fn_matches_jax(kind, warm, decay, floor):
    jf = jopt.lr_scale_fn(kind, warm, decay, floor)
    tf = topt.lr_scale_fn(kind, warm, decay, floor)
    for step in range(1, 16):
        np.testing.assert_allclose(tf(step), float(jf(jnp.float32(step))), rtol=1e-6)
    assert topt.lr_scale_fn("constant") is None


@pytest.mark.parametrize("tick_all", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_masked_adam_matches_jax_over_a_partition_period(jparams, tick_all, moments):
    """Fifteen updates of G's parameters (a full period of 3 groups x 5
    batches) with the partition masks, the same gradients in both packages;
    params, moments and counts after each one."""
    g_tree = {k: jparams[k] for k in jm.GENERATOR_SUBTREES}
    masks = jpart.build_partition_masks(jparams)["generator"]
    mdt = jnp.dtype(moments)
    jstate = jopt.adam_init(g_tree, dtype=mdt)
    names = _model_names(jparams, jm.GENERATOR_SUBTREES)
    tparams = {n: t(v).clone() for n, v in zip(names, _flatten(g_tree).values())}
    tmasks = tpart.build_partition_masks(names, [], [])["generator"]
    tstate = topt.adam_init(tparams, getattr(torch, moments))
    rng = np.random.default_rng(1)
    jp = g_tree
    for batch_no in range(1, 16):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1 for k, v in _flatten(jp).items()}
        jgrads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp), list(grads.values()))
        jmask = jpart.resolve_mask(masks, jnp.int32(batch_no), True, 4)
        jp, jstate = jopt.masked_adam_update(jgrads, jstate, jp, jmask, 5e-5, 0.5, 0.9, tick_all=tick_all)
        tmask = tpart.resolve_mask(tmasks, batch_no, True, 4)
        topt.masked_adam_update({n: t(g) for n, g in zip(names, grads.values())}, tstate, tparams, tmask,
                                5e-5, 0.5, 0.9, tick_all=tick_all)
        # f32 moments exactly (JAX's rounding order); bf16 storage to two of
        # its ulps (2^-7): the f32 update of a weight may differ in its last
        # bit, which moves the next moments' rounding, and a weight by up to
        # lr_t * 2^-7 (~2e-7) more or less
        mtol = 0.0 if moments == "float32" else 2 ** -7
        patol = 1e-9 if moments == "float32" else 2e-7
        for n, (k, want) in zip(names, _flatten(jp).items()):
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(want), rtol=1e-6, atol=patol, err_msg=k)
        for part, tpart_ in (("mu", tstate.mu), ("nu", tstate.nu)):
            for n, (k, want) in zip(names, _flatten(getattr(jstate, part)).items()):
                np.testing.assert_allclose(tpart_[n].float().numpy(), np.asarray(want, np.float32),
                                           rtol=mtol, atol=1e-10 if mtol else 0.0, err_msg=f"{part} {k} at {batch_no}")
        assert [tstate.count[n] for n in names] == [int(c) for c in _flatten(jstate.count).values()]


def test_masked_adam_leaves_masked_off_leaves_untouched_by_nan():
    p = {"a": torch.ones(3), "b": torch.ones(3)}
    state = topt.adam_init(p)
    grads = {"a": torch.full((3,), float("nan")), "b": torch.ones(3)}
    topt.masked_adam_update(grads, state, p, {"a": 0.0, "b": 1.0}, 1e-3, 0.5, 0.9)
    assert torch.equal(p["a"], torch.ones(3)) and torch.equal(state.mu["a"], torch.zeros(3))
    assert state.count == {"a": 0, "b": 1} and bool((p["b"] < 1).all())


# weights (of 13 x 5 x 200k) whose f32 update may differ from JAX's, by one
# ulp of the larger of the weight and its step: the rounding order is JAX's,
# but XLA may fuse the last subtract differently (2 differed when this was set)
ADAM_BIT_MISSES = 8


@pytest.mark.parametrize("form", ["host", "rows"])
def test_masked_adam_equals_jax_bit_for_bit(form):
    """One f32 update of five 200k-weight leaves at each apply count 1-13
    (b1 0.5, b2 0.999), from the same weights, moments and gradients, through
    JAX ``masked_adam_update`` and the port's host form
    (``masked_adam_update``) or row form (``advance_counts`` +
    ``masked_adam_update_rows``): moments and counts equal bit for bit, the
    weights on all but ``ADAM_BIT_MISSES``."""
    rng = np.random.default_rng(0)
    names, n = [f"l{i}" for i in range(5)], 200_000
    misses = 0
    for c in range(1, 14):
        draw = lambda scale: {k: (rng.normal(size=n) * scale).astype(np.float32) for k in names}  # noqa: E731
        p, g = draw(1.0), draw(0.1)
        m = draw(0.05) if c > 1 else {k: np.zeros(n, np.float32) for k in names}
        v = {k: np.abs(a) for k, a in draw(0.01).items()} if c > 1 else {k: np.zeros(n, np.float32) for k in names}
        jstate = jopt.AdamState(count={k: jnp.int32(c - 1) for k in names}, mu={k: jnp.asarray(m[k]) for k in names},
                                nu={k: jnp.asarray(v[k]) for k in names})
        ones = {k: 1.0 for k in names}
        jp, jstate = jopt.masked_adam_update({k: jnp.asarray(g[k]) for k in names}, jstate,
                                             {k: jnp.asarray(p[k]) for k in names}, ones, 5e-5, 0.5, 0.999)
        tp, tg = {k: t(p[k]) for k in names}, {k: t(g[k]) for k in names}
        tstate = topt.AdamState(count={k: c - 1 for k in names}, mu={k: t(m[k]) for k in names},
                                nu={k: t(v[k]) for k in names})
        if form == "host":
            topt.masked_adam_update(tg, tstate, tp, ones, 5e-5, 0.5, 0.999)
        else:
            steps = topt.advance_counts(tstate, np.ones((1, len(names)), np.float32), 5e-5, 0.5, 0.999)
            topt.masked_adam_update_rows(tg, tstate, tp, torch.ones(len(names)), t(steps[0]), 0.5, 0.999)
        for k in names:
            np.testing.assert_array_equal(tstate.mu[k].numpy(), np.asarray(jstate.mu[k]), err_msg=f"mu {k} at {c}")
            np.testing.assert_array_equal(tstate.nu[k].numpy(), np.asarray(jstate.nu[k]), err_msg=f"nu {k} at {c}")
            assert tstate.count[k] == int(jstate.count[k]) == c
            got, want = tp[k].numpy(), np.asarray(jp[k])
            off = got != want
            misses += int(off.sum())
            ulp = np.spacing(np.maximum(np.abs(want), np.abs(p[k] - want)))
            assert np.all(np.abs(got - want)[off] <= ulp[off]), (k, c)
    assert misses <= ADAM_BIT_MISSES, misses


# ------------------------------------------------------ encoder gradients --


def test_encoder_grads_with_both_kernel_flags_match_jax(tiny_cfg):
    """D's parameter gradients with use_pallas and use_pallas_boundary on
    in both packages: JAX runs its Pallas kernels' custom VJPs in interpret
    mode, the port its Functions' plain backwards; the gradient reaches
    encoder.block1's kernel through the s2d rearrangement and the cast."""
    jcfg = tiny_cfg.replace(image_dim=32, init_dim=2, conv_filter=[48, 32, 24, 16, 8], use_s2d=True,
                            use_pallas=True, use_pallas_boundary=True)
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)), jnp.float32)

    def loss(p):
        pr, cond = jm.discriminator_apply(p, x, jcfg)
        return jnp.sum(pr) + jnp.sum(cond)

    want = _flatten(jax.grad(loss)(params))
    model = params_from_jax(_flatten(params), tm.LittleGAN(tcfg_of(jcfg)))
    pr, cond = model.discriminator(t(np.asarray(x)))
    (pr.sum() + cond.sum()).backward()
    for n, p in model.named_parameters():
        key = n.replace(".", "/")
        if key.startswith(("encoder", "d_head")):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[key]), rtol=1e-3, atol=1e-5, err_msg=key)
        else:
            assert p.grad is None, key
    assert float(model.encoder.block1.conv.kernel.grad.abs().sum()) > 0


@pytest.mark.parametrize("flag", ["use_pallas", "use_pallas_boundary"])
def test_gp_with_a_kernel_flag_builds_at_every_step_maker(tiny_cfg, flag, monkeypatch):
    """The gradient penalty with a kernel flag set is built at every step
    maker (the flag does not reach the port), and its step takes the plain
    route by itself: no kernel Function is called, the losses are finite."""
    from test_torch_same_border import KERNEL_FUNCTIONS, _Calls

    calls = _Calls(monkeypatch, KERNEL_FUNCTIONS)
    tc = tcfg_of(tiny_cfg).replace(use_gp=True, use_s2d=True, **{flag: True})
    state = create_train_state(tc, "cpu")
    for make in (tstep.make_train_step, tstep.make_accum_train_step, tstep.make_gather_train_step,
                 lambda c, s: tstep.make_scan_train_step(c, s, 2),
                 lambda c, s: tstep.make_scan_accum_train_step(c.replace(grad_accum=2), s, 2)):
        make(tc, state)
    rng = np.random.default_rng(6)
    b1, b2 = batch(rng, tc), batch(rng, tc)
    draws = jax_step_draws(jax.random.PRNGKey(6), tc, b1[0].shape)
    out = tstep.make_train_step(tc, state)(state, (t(b1[0]), t(b1[1])), (t(b2[0]), t(b2[1])), draws, 12)
    assert all(np.isfinite(float(v)) for v in out.metrics.values())
    assert calls.counts == {}


def test_prep_images_rescales_uint8_only():
    u8 = torch.tensor([[0, 255, 128]], dtype=torch.uint8)
    np.testing.assert_allclose(tstep.prep_images(u8).numpy(), [[-1.0, 1.0, 128 / 127.5 - 1.0]], rtol=0, atol=1e-7)
    f = torch.rand(2, 3)
    assert tstep.prep_images(f) is f
