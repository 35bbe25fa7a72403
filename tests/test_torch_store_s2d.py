"""The device-store steps over an s2d-layout store (``store_s2d=True``)
against the same steps over the raw store, on the CPU in f32.

The s2d store holds each batch as ``ops/s2d.py::space_to_depth`` of the raw
one; the step then skips its per-step rearrangement and augments batch 1
with ``augment_s2d``. The networks see the same values in either layout
(``augment_s2d`` sums the contrast mean over a raw-layout copy, in the raw
path's order), and the updates agree bit for bit: losses, the last
update's image, weights, moments and counts. That is tighter than the JAX
package's bounds (tests/test_s2d.py: losses 1e-4, weights 2.5 x lr), where
the two layouts sum the mean in other orders.
"""

import numpy as np
import pytest
import torch

from littlegan_tpu_torch.ops.s2d import space_to_depth
from littlegan_tpu_torch.training import step as tstep
from littlegan_tpu_torch.training.state import create_train_state
from test_torch_dispatch import _clone_state, _same_state
from test_torch_train import tcfg_of

N_BATCHES = 6


def _store(cfg, seed=11):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (N_BATCHES, cfg.batch_size, cfg.image_dim, cfg.image_dim, 3), np.uint8)
    conds = np.where(rng.random((N_BATCHES, cfg.batch_size, cfg.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32)
    raw = torch.from_numpy(imgs)
    s2d = space_to_depth(raw.flatten(0, 1)).reshape(N_BATCHES, cfg.batch_size, *space_to_depth(raw[0]).shape[1:])
    return raw, s2d.contiguous(), torch.from_numpy(conds)


def _draws(cfg, seed, lead=()):
    gen = torch.Generator().manual_seed(seed)
    n = int(np.prod(lead))
    draws = [tstep.draw_step(gen, cfg, cfg.batch_size, "cpu") for _ in range(max(n, 1))]
    if not lead:
        return draws[0]
    stacked = tstep.stack_draws(draws)
    return tstep.map_draws(lambda x: x.reshape(*lead, *x.shape[1:]), stacked)


def _run(kind, cfg, state, store_s2d, images, conds):
    if kind == "gather":
        step = tstep.make_gather_train_step(cfg, state, store_s2d=store_s2d)
        return step(state, images, conds, 2, 5, _draws(cfg, 1), 21)
    if kind == "scan":
        step = tstep.make_scan_train_step(cfg, state, 2, store_s2d=store_s2d)
        return step(state, images, conds, np.array([2, 0]), np.array([5, 3]), _draws(cfg, 2, (2,)), 20)
    step = tstep.make_scan_accum_train_step(cfg, state, 2, store_s2d=store_s2d)
    return step(state, images, conds, np.array([[2, 1], [0, 4]]), np.array([[5, 3], [1, 2]]),
                _draws(cfg, 3, (2, 2)), 20)


@pytest.mark.parametrize("kind", ["gather", "scan", "scan_accum"])
def test_s2d_store_matches_raw_store(tiny_cfg, kind):
    cfg = tcfg_of(tiny_cfg).replace(use_s2d=True, use_partition=True, grad_accum=2 if kind == "scan_accum" else 1)
    raw, s2d, conds = _store(cfg)
    state = create_train_state(cfg, "cpu")
    other = _clone_state(state, cfg)
    want = _run(kind, cfg, state, False, raw, conds)
    got = _run(kind, cfg, other, True, s2d, conds)
    for k in tstep.LOSS_KEYS:
        np.testing.assert_array_equal(got.metrics[k].numpy(), want.metrics[k].numpy(), err_msg=k)
    assert got.fake_image.shape == want.fake_image.shape == (cfg.batch_size, cfg.image_dim, cfg.image_dim, 3)
    assert torch.equal(got.fake_image, want.fake_image)
    _same_state(other, state)


@pytest.mark.parametrize("kw", [dict(use_s2d=False), dict(kernel_size=3)], ids=["no_s2d", "kernel3"])
def test_s2d_store_refused_when_s2d_is_inactive(tiny_cfg, kw):
    """As JAX ``_check_store_layout``: a clear error when the step is built,
    not a shape error inside the first update; a raw store is taken."""
    cfg = tcfg_of(tiny_cfg).replace(**kw)
    state = create_train_state(cfg, "cpu")
    for make in (tstep.make_gather_train_step, lambda c, s, store_s2d: tstep.make_scan_train_step(c, s, 2, store_s2d),
                 lambda c, s, store_s2d: tstep.make_scan_accum_train_step(c, s, 2, store_s2d)):
        with pytest.raises(ValueError, match="store_s2d=True but the s2d step is inactive"):
            make(cfg, state, store_s2d=True)
        make(cfg, state, store_s2d=False)
