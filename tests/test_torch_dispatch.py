"""The port's device-store steps (gather, K-update scan, gradient
accumulation) against the JAX package's, and the schedule rows and the
row form of masked Adam they run on, on the CPU in f32.

Each JAX case runs one JAX program (``make_gather_train_step``,
``make_scan_train_step``, ``make_scan_accum_train_step`` or
``make_accum_train_step``, jitted, ~20 s to compile) and the port's
counterpart on the same weights, uint8 store and draws: the draws are
recomputed from the JAX keys (``fold_in(base, global_step0 + i)``, then
``fold_in(., j)`` per micro-step) in ``_micro_grads``' split order. The
JAX side runs without its Pallas kernels (they are held against the
port's Functions in tests/test_torch_train.py); the port's "kernels"
cases run its Functions' plain versions. The K-update steps run their
updates eagerly here (a CPU state); on the card they are one CUDA graph
replay (``chip_smoke.py`` phase (e)).

Tolerances: the first update's losses rtol 1e-5 (as tests/test_torch_step.py),
a later update's rtol 1e-3 (its weights carry the earlier updates'
differences); counts exact; weights atol 3 x lr per update (Adam moves each
weight by about ±lr_t per update whatever the gradient's size, so a
near-zero gradient of the other sign moves it the other way); first and
second moments, and the mean gradients of ``accum_grads``, as
tests/test_torch_step.py (moments rtol 2e-3 / atol 1e-6 and 1e-9, bf16
moments 2^-7; gradients rtol 1e-3 / atol 1e-6): the moments carry the
gradients, which the weights of a first Adam step do not (it moves each
weight by ±lr_t whatever the gradient); the last update's images atol
1e-3. The port against itself (the K-update path against K one-update
steps, the row form of Adam against the host form): bit for bit. The host
form against a fused ``p + (-lr_t) * m / (sqrt(v) + eps)``: one ulp of
each weight (or of its step, where that is larger).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.models import littlegan as jm
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training import partition as jpart
from littlegan_tpu.training import step as jstep
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.training import optimizer as topt
from littlegan_tpu_torch.training import partition as tpart
from littlegan_tpu_torch.training import step as tstep
from littlegan_tpu_torch.training.checkpoint import flatten_state
from littlegan_tpu_torch.training.state import create_train_state
from test_torch_step import GRAD_TOL
from test_torch_train import jax_step_draws, port_state, t, tcfg_of

N_BATCHES = 10
KERNELS = dict(use_pallas=True, use_pallas_boundary=True)


def make_store(rng, cfg, n=N_BATCHES):
    imgs = rng.integers(0, 256, (n, cfg.batch_size, cfg.image_dim, cfg.image_dim, cfg.image_channel), np.uint8)
    conds = np.where(rng.random((n, cfg.batch_size, cfg.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32)
    return imgs, conds


def jax_update_draws(key, cfg, shape, m=None):
    """The port's draws of the update whose JAX key is ``key``: its step
    draws, or its M micro-steps' (``fold_in(key, j)``) stacked."""
    if m is None:
        return jax_step_draws(key, cfg, shape)
    return tstep.stack_draws([jax_step_draws(jax.random.fold_in(key, j), cfg, shape) for j in range(m)])


def _same_state(a, b):
    fa, fb = flatten_state(a), flatten_state(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        raw = lambda x: np.ascontiguousarray(x).reshape(-1).view(np.uint8)  # noqa: E731
        np.testing.assert_array_equal(raw(fa[k]), raw(fb[k]), err_msg=k)


def _clone_state(state, cfg):
    """A copy of a port state: weights, moments, counts, EMA."""
    model = type(state.model)(cfg)
    model.load_state_dict(state.model.state_dict())
    new = create_train_state(cfg, "cpu", model)
    for opt in ("opt_g", "opt_d", "opt_a"):
        src, dst = getattr(state, opt), getattr(new, opt)
        dst.count.update(src.count)
        for k in src.mu:
            dst.mu[k].copy_(src.mu[k])
            dst.nu[k].copy_(src.nu[k])
    if state.ema is not None:
        for k, e in state.ema.items():
            new.ema[k].copy_(e)
    return new


# ------------------------------------------------------------ schedule rows --


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return jm.init_params(tiny_cfg, jax.random.PRNGKey(0))


def _names(jparams, keys):
    return [k.replace("/", ".") for k in _flatten({k: jparams[k] for k in keys})]


@pytest.mark.parametrize("which", ["generator", "discriminator", "adjuster"])
@pytest.mark.parametrize("use_partition,train_adj", [(True, True), (False, True), (True, False)])
def test_mask_rows_match_jax_resolve_mask(jparams, which, use_partition, train_adj):
    """Rows for batch_no 0…30 against JAX ``resolve_mask``, the adjuster's
    times JAX ``apply_updates``' gate ((batch_no > 10), or 0 without the
    adjuster)."""
    jmasks = jpart.build_partition_masks(jparams)[which]
    stacked = tpart.build_partition_masks(
        _names(jparams, jm.GENERATOR_SUBTREES), _names(jparams, jm.DISCRIMINATOR_SUBTREES),
        _names(jparams, jm.ADJUSTER_TRAINABLE),
    )
    rows = tpart.mask_rows(stacked, range(31), use_partition, 4, train_adj)[which]
    assert rows.shape == (31, len(stacked[which])) and rows.dtype == np.float32
    for batch_no in range(31):
        want = np.asarray(list(_flatten(jpart.resolve_mask(jmasks, jnp.int32(batch_no), use_partition, 4)).values()))
        if which == "adjuster":
            want = want * float(train_adj and batch_no > 10)
        np.testing.assert_array_equal(rows[batch_no], want, err_msg=str(batch_no))


@pytest.mark.parametrize("tick_all,schedule", [(False, None), (True, None), (False, "linear")])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_row_form_adam_matches_host_form(tick_all, schedule, moments):
    """Fifteen updates of four leaves under a partition schedule through
    ``masked_adam_update`` and through ``advance_counts`` +
    ``masked_adam_update_rows``: the same weights, moments and counts bit for
    bit. A non-finite gradient on a masked-off leaf leaves it untouched."""
    rng = np.random.default_rng(2)
    shapes = {"a.kernel": (3, 4), "a.bias": (4,), "b.kernel": (4, 2), "b.bias": (2,)}
    host = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    rows_p = {k: v.clone() for k, v in host.items()}
    mdt = getattr(torch, moments)
    s_host, s_rows = topt.adam_init(host, mdt), topt.adam_init(rows_p, mdt)
    lr_scale = topt.lr_scale_fn(schedule, 3, 10, 0.1) if schedule else None
    stacked = {"a.kernel": [1.0, 0.0], "a.bias": [1.0, 0.0], "b.kernel": [0.0, 1.0], "b.bias": [0.0, 1.0]}
    masks = tpart.mask_rows({"generator": stacked, "adjuster": {"c": [1.0]}}, range(1, 16), True, 2, True)
    masks = masks["generator"]
    for i, row in enumerate(masks):
        grads = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
        off = [k for k, on in zip(shapes, row) if on == 0]
        if off:
            grads[off[0]][0] = float("nan") if i % 2 else float("inf")
        topt.masked_adam_update(grads, s_host, host, dict(zip(shapes, row)), 1e-3, 0.5, 0.9, tick_all=tick_all,
                                lr_scale=lr_scale)
        steps = topt.advance_counts(s_rows, row[None], 1e-3, 0.5, 0.9, tick_all, lr_scale)
        topt.masked_adam_update_rows(grads, s_rows, rows_p, torch.from_numpy(row), torch.from_numpy(steps[0]),
                                     0.5, 0.9)
        assert s_host.count == s_rows.count
        for k in shapes:
            for a, b in ((host[k], rows_p[k]), (s_host.mu[k], s_rows.mu[k]), (s_host.nu[k], s_rows.nu[k])):
                assert torch.equal(a, b), (i, k)
            assert bool(torch.isfinite(rows_p[k]).all() and torch.isfinite(s_rows.nu[k].float()).all()), (i, k)


def test_schedule_rows_layout_and_counts(tiny_cfg):
    """(K, width) rows: per Adam its masks then its step sizes, then the
    parity; the counts end where K host-form updates leave them."""
    tc = tcfg_of(tiny_cfg.replace(adam_tf_parity=True))
    state = port_state(jcreate_train_state(tiny_cfg, jax.random.PRNGKey(0)), tiny_cfg)[0]
    host = _clone_state(state, tc)
    pm = tstep.partition_masks(state.model)
    rows = tstep.schedule_rows(state, tc, pm, range(9, 13))
    assert rows.shape == (4, tstep.schedule_width(state)) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, -1], [1, 0, 1, 0])
    n_g, n_d = len(state.opt_g.count), len(state.opt_d.count)
    a0 = 2 * (n_g + n_d)
    np.testing.assert_array_equal(rows[:, a0], [0, 0, 1, 1])  # the adjuster's gate opens after batch 10
    for batch_no in range(9, 13):
        grads = {n: torch.zeros_like(p) for n, p in host.model.named_parameters()}
        aux = {k: torch.zeros(()) for k in tstep.LOSS_KEYS} | {"fake": None, "adj": None}
        tstep.apply_updates(host, grads, aux, batch_no, tc, pm)
    for opt in ("opt_g", "opt_d", "opt_a"):
        assert getattr(state, opt).count == getattr(host, opt).count, opt
    lr_t = topt.adam_lr_t(tc.lr, tc.beta_1, tc.beta_2, state.opt_g.count[next(iter(state.opt_g.count))])
    assert rows[-1, n_g] == np.float32(lr_t)  # tick_all: every G leaf at the same count


def test_store_layout_checks(tiny_cfg):
    """An s2d-layout store is taken where the s2d step is active (its
    updates: tests/test_torch_store_s2d.py) and refused where it is not."""
    tc = tcfg_of(tiny_cfg.replace(use_s2d=True))
    state = port_state(jcreate_train_state(tiny_cfg, jax.random.PRNGKey(0)), tiny_cfg)[0]
    assert callable(tstep.make_gather_train_step(tc, state, store_s2d=True))
    with pytest.raises(ValueError, match="inactive"):
        tstep.make_scan_train_step(tc.replace(use_s2d=False), state, 2, store_s2d=True)
    store = torch.arange(24).reshape(4, 3, 2)
    assert torch.equal(tstep.take_batch(store, 2), store[2])
    assert torch.equal(tstep.take_batch(store, torch.tensor(3)), store[3])


# ----------------------------------------------- the port against itself --


def _port_case(tiny_cfg, flags, seed=0):
    jcfg = tiny_cfg.replace(**flags)
    state, tc = port_state(jcreate_train_state(jcfg, jax.random.PRNGKey(seed)), jcfg)
    rng = np.random.default_rng(seed)
    imgs, conds = make_store(rng, tc)
    gen = torch.Generator().manual_seed(seed)
    draw = lambda: tstep.draw_step(gen, tc, tc.batch_size, "cpu")  # noqa: E731
    return state, tc, torch.from_numpy(imgs), torch.from_numpy(conds), rng, draw


@pytest.mark.parametrize("flags", [dict(use_s2d=True, **KERNELS), dict(use_s2d=True, adj_half_batch=True,
                                                                         ema_decay=0.9, moment_dtype="bfloat16"),
                                   dict(use_s2d=False, train_adj=False, adam_tf_parity=True)])
def test_scan_step_equals_sequential_gather_steps(tiny_cfg, flags):
    """K = 4 updates from batch 9 (a partition batch at 10, the gate opening
    at 11, both adjuster parities) in one call, against four gather steps:
    the same state, losses and last images, bit for bit."""
    state, tc, imgs, conds, rng, draw = _port_case(tiny_cfg, flags)
    seq = _clone_state(state, tc)
    b1s, b2s = rng.integers(0, N_BATCHES, 4), rng.integers(0, N_BATCHES, 4)
    draws = [draw() for _ in range(4)]
    out = tstep.make_scan_train_step(tc, state, 4)(state, imgs, conds, b1s, b2s, tstep.stack_draws(draws), 9)
    gather = tstep.make_gather_train_step(tc, seq)
    for i in range(4):
        ref = gather(seq, imgs, conds, int(b1s[i]), int(b2s[i]), draws[i], 9 + i)
        for k in tstep.LOSS_KEYS:
            assert torch.equal(out.metrics[k][i], ref.metrics[k]), (i, k)
    assert torch.equal(out.fake_image, ref.fake_image) and torch.equal(out.adj_image, ref.adj_image)
    _same_state(state, seq)


@pytest.mark.parametrize("flags", [dict(use_s2d=True, **KERNELS), dict(use_s2d=False, adj_half_batch=True)])
def test_scan_accum_step_equals_sequential_accum_steps(tiny_cfg, flags):
    """K = 2 updates of M = 3 micro-pairs in one call against two
    ``accum_train_step``s on the same batches and draws, bit for bit."""
    state, tc, imgs, conds, rng, draw = _port_case(tiny_cfg, dict(grad_accum=3, **flags), seed=1)
    seq = _clone_state(state, tc)
    b1s, b2s = rng.integers(0, N_BATCHES, (2, 3)), rng.integers(0, N_BATCHES, (2, 3))
    draws = [tstep.stack_draws([draw() for _ in range(3)]) for _ in range(2)]
    out = tstep.make_scan_accum_train_step(tc, state, 2)(state, imgs, conds, b1s, b2s, tstep.stack_draws(draws), 10)
    for i in range(2):
        pick = lambda ids: (imgs[torch.from_numpy(ids)], conds[torch.from_numpy(ids)])  # noqa: E731
        ref = tstep.accum_train_step(seq, pick(b1s[i]), pick(b2s[i]), draws[i], 10 + i, tc)
        for k in tstep.LOSS_KEYS:
            assert torch.equal(out.metrics[k][i], ref.metrics[k]), (i, k)
    assert torch.equal(out.fake_image, ref.fake_image)
    _same_state(state, seq)


def test_accum_of_one_micro_pair_is_the_train_step(tiny_cfg):
    """M = 1: the mean of one gradient is that gradient, bit for bit."""
    state, tc, imgs, conds, rng, draw = _port_case(tiny_cfg, dict(use_s2d=True))
    seq = _clone_state(state, tc)
    d = draw()
    a = tstep.accum_train_step(state, (imgs[:1], conds[:1]), (imgs[1:2], conds[1:2]), tstep.stack_draws([d]), 12, tc)
    b = tstep.train_step(seq, (imgs[0], conds[0]), (imgs[1], conds[1]), d, 12, tc)
    assert all(torch.equal(a.metrics[k], b.metrics[k]) for k in tstep.LOSS_KEYS)
    _same_state(state, seq)


# ------------------------------------------------------- against the JAX steps --

# name: (config changes, kind, K, M, batch_no0). The scan crosses the partition
# batch 10 and the adjuster gate (batch_no > 10) with both parities of the
# half-batch adjuster; the scan-accum case opens the gate between its updates
JAX_CASES = {
    "gather+kernels": (dict(use_s2d=True, **KERNELS), "gather", 1, None, 12),
    "scan3+adj_half": (dict(use_s2d=True, adj_half_batch=True), "scan", 3, None, 9),
    "scan_accum+kernels+ema": (dict(use_s2d=True, ema_decay=0.9, **KERNELS), "scan_accum", 2, 2, 10),
    "accum": (dict(use_s2d=False), "accum", 1, 2, 5),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_device_store_steps_match_jax(tiny_cfg, case):
    flags, kind, k, m, batch_no0 = JAX_CASES[case]
    jcfg = tiny_cfg.replace(donate_state=False, grad_accum=m or 1, **flags)
    port_flags = dict(use_pallas=jcfg.use_pallas, use_pallas_boundary=jcfg.use_pallas_boundary)
    jcfg = jcfg.replace(use_pallas=False, use_pallas_boundary=False)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0))
    state, tc = port_state(jstate, jcfg.replace(**port_flags))
    rng = np.random.default_rng(batch_no0)
    imgs, conds = make_store(rng, jcfg)
    timgs, tconds = torch.from_numpy(imgs), torch.from_numpy(conds)
    shape = imgs.shape[1:]
    base, gs0 = jax.random.PRNGKey(3), 40
    ids = rng.integers(0, N_BATCHES, (2, k, m or 1))
    if kind == "gather":
        b1, b2 = int(ids[0, 0, 0]), int(ids[1, 0, 0])
        key = jax.random.fold_in(base, gs0)
        jout = jstep.make_gather_train_step(jcfg, jstate.params, donate=False)(
            jstate, imgs, conds, jnp.int32(b1), jnp.int32(b2), key, jnp.int32(batch_no0))
        out = tstep.make_gather_train_step(tc, state)(state, timgs, tconds, b1, b2,
                                                      jax_update_draws(key, jcfg, shape), batch_no0)
    elif kind == "accum":
        key = jax.random.fold_in(base, gs0)
        b1s = (imgs[ids[0, 0]], conds[ids[0, 0]])
        b2s = (imgs[ids[1, 0]], conds[ids[1, 0]])
        jout = jstep.make_accum_train_step(jcfg, jstate.params, donate=False)(
            jstate, b1s, b2s, key, jnp.int32(batch_no0))
        out = tstep.accum_train_step(state, tuple(map(t, b1s)), tuple(map(t, b2s)),
                                     jax_update_draws(key, jcfg, shape, m), batch_no0, tc)
    else:
        b1s, b2s = (ids[0], ids[1]) if m else (ids[0, :, 0], ids[1, :, 0])
        make_j = jstep.make_scan_accum_train_step if m else jstep.make_scan_train_step
        jout = make_j(jcfg, jstate.params, k, donate=False)(
            jstate, imgs, conds, jnp.asarray(b1s, jnp.int32), jnp.asarray(b2s, jnp.int32), base,
            jnp.int32(gs0), jnp.int32(batch_no0))
        draws = tstep.stack_draws([jax_update_draws(jax.random.fold_in(base, gs0 + i), jcfg, shape, m)
                                   for i in range(k)])
        make_t = tstep.make_scan_accum_train_step if m else tstep.make_scan_train_step
        out = make_t(tc, state, k)(state, timgs, tconds, b1s, b2s, draws, batch_no0)

    for key_ in tstep.LOSS_KEYS:
        got = np.atleast_1d(out.metrics[key_].numpy())
        want = np.atleast_1d(np.asarray(jout.metrics[key_]))
        assert got.shape == want.shape == (k,)
        np.testing.assert_allclose(got[:1], want[:1], rtol=1e-5, err_msg=key_)
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=key_)
    np.testing.assert_allclose(out.fake_image.numpy(), np.asarray(jout.fake_image), rtol=0, atol=1e-3)
    np.testing.assert_allclose(out.adj_image.numpy(), np.asarray(jout.adj_image), rtol=0, atol=1e-3)
    want, got = _flatten(jout.state), flatten_state(out.state)
    assert sorted(got) == sorted(want)
    for key_, w in want.items():
        g, w = got[key_], np.asarray(w)
        part = key_.split("/")[1]
        if part == ".count":
            assert int(g) == int(w), key_
        elif g.dtype.kind == "V":  # bf16 moments, stored as raw 2-byte words
            g = torch.from_numpy(g.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
            np.testing.assert_allclose(g, w.astype(np.float32), rtol=2 ** -7, atol=1e-6, err_msg=key_)
        elif key_.startswith((".params/", ".ema/")):
            np.testing.assert_allclose(g, w, rtol=0, atol=3 * k * jcfg.lr, err_msg=key_)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6 if part == ".mu" else 1e-9, err_msg=key_)


@pytest.mark.parametrize("adj_half", [False, True])
def test_accum_grads_match_jax(tiny_cfg, adj_half):
    """The mean gradients over M = 3 micro-pairs (and the last micro-step's
    losses) against JAX ``accum_grads`` on the same weights, store batches
    and draws; with the half-batch adjuster its device-side choice."""
    jcfg = tiny_cfg.replace(donate_state=False, use_s2d=True, adj_half_batch=adj_half, grad_accum=3)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(1))
    state, tc = port_state(jstate, jcfg)
    rng = np.random.default_rng(4)
    imgs, conds = make_store(rng, jcfg)
    ids1, ids2 = rng.integers(0, N_BATCHES, 3), rng.integers(0, N_BATCHES, 3)
    key = jax.random.PRNGKey(9)
    j_sel = jnp.int32(1) if adj_half else None
    jgrads, jaux = jax.jit(lambda st, b1s, b2s, r, sel: jstep.accum_grads(st, b1s, b2s, r, jcfg, adj_sel=sel))(
        jstate, (imgs[ids1], conds[ids1]), (imgs[ids2], conds[ids2]), key, j_sel)
    t_sel = torch.ones((), dtype=torch.int64) if adj_half else None
    grads, aux = tstep.accum_grads(state, (t(imgs[ids1]), t(conds[ids1])), (t(imgs[ids2]), t(conds[ids2])),
                                   jax_update_draws(key, jcfg, imgs.shape[1:], 3), tc, t_sel)
    for k in tstep.LOSS_KEYS:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    want = _flatten(jgrads)
    assert sorted(k.replace("/", ".") for k in want) == sorted(grads)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k.replace("/", ".")].numpy(), np.asarray(w), **GRAD_TOL, err_msg=k)


def test_host_form_adam_within_an_ulp_of_fused_addcdiv():
    """``masked_adam_update`` subtracts ``(lr_t * m) / denom`` (the row
    form's and JAX's arithmetic) where a fused ``addcdiv`` adds ``-lr_t * m / denom``
    from the same moments: over twenty updates of float32 leaves each
    weight stays within one ulp of the fused update's (of the larger of
    the weight and its step, where the weight is smaller than its step)."""
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 33), "b": (17,)}
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    state = topt.adam_init(params, torch.float32)
    for i in range(20):
        grads = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
        before = {k: p.clone() for k, p in params.items()}
        fused = {k: p.clone() for k, p in params.items()}
        topt.masked_adam_update(grads, state, params, {k: 1.0 for k in shapes}, 1e-3, 0.5, 0.9)
        lr_t = topt.adam_lr_t(1e-3, 0.5, 0.9, i + 1)
        for k in shapes:
            fused[k].addcdiv_(state.mu[k], state.nu[k].sqrt() + 1e-8, value=-lr_t)
            f, step = fused[k].numpy(), (before[k] - fused[k]).abs().numpy()
            ulp = np.spacing(np.maximum(np.abs(f), step))
            assert np.all(np.abs(params[k].numpy() - f) <= ulp), (i, k)
            params[k].copy_(fused[k])
