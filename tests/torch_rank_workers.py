"""Rank workers of the store-decode and checkpoint tests, run by
``torch_dp_common.run_ranks("torch_rank_workers:<function>", ...)`` in gloo
processes that import torch and the port only, never JAX.

- :func:`store_decode`: a ``Trainer`` epoch over a dataset that counts the
  rows it yields, beside the same epoch with the batches made the way the
  port made them before each rank decoded only its rows (the whole
  dataset, then this rank's rows and H-slice);
- :func:`store_mismatch`: a rank whose dataset holds fewer batches than the
  others' builds no store, and every rank raises;
- :func:`ckpt_runs`: ``Trainer`` runs whose ranks share one result tree,
  on the orbax backend and the npz one: unbroken, and stopped after an
  epoch then resumed;
- :func:`ckpt_restore`: a ``Trainer`` that restores a checkpoint another
  layout of ranks wrote;
- :func:`dropout_forward`: D and A under a spatial mesh with the global
  dropout masks;
- :func:`run_cases`: several of these (``case["fn"]``) in one start of the
  ranks.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.data.synthetic import SyntheticDataset
from torch_dp_common import with_shard_threshold


class SpyDataset(SyntheticDataset):
    """The synthetic set, recording the rows of each batch it yields."""

    def __init__(self, cfg: Config, num_items: int):
        super().__init__(cfg, num_items)
        self.yielded: list = []

    def epoch_iterator(self, *args, **kwargs):
        for img, cond in super().epoch_iterator(*args, **kwargs):
            self.yielded.append(img.shape[0])
            yield img, cond


def rank_cfg(dg, case: Dict[str, Any], name: str) -> Config:
    """``case["cfg"]`` writing under ``case["root"]/<name>/r<rank>``."""
    rank = 0 if dg is None else dg.rank
    root = os.path.join(case["root"], name, f"r{rank}")
    return Config(**{**case["cfg"], "all_result_dir": os.path.join(root, "result"),
                     "test_data_dir": os.path.join(root, "test-data")})


def logging_trainer(cfg: Config, data, dg):
    """A ``Trainer`` on the CPU whose flushed losses are kept in ``.logged``."""
    from littlegan_tpu_torch.training.trainer import Trainer

    tr = Trainer(cfg, data, device="cpu", group=dg)
    tr.logged = []
    flush = tr._flush_buffered

    def spy():
        tr.logged.extend((s0, {k: np.atleast_1d(v.numpy()) for k, v in m.items()})
                         for s0, _, m in tr._metrics_buffer)
        flush()

    tr._flush_buffered = spy
    return tr


def _old_store(cfg: Config, dp, items: int):
    """The store as the port built it before: every row of the whole
    dataset, then this rank's rows and H-slice of each batch."""
    import torch

    from littlegan_tpu_torch.parallel.mesh import h_slice, row_slice

    images, conds = zip(*SyntheticDataset(cfg, items).epoch_iterator(0, shuffle=False))
    b = cfg.batch_size
    imgs, cs = np.concatenate(images), np.concatenate(conds).astype(np.float32)
    n = imgs.shape[0] // b
    imgs, cs = imgs[: n * b].reshape(n, b, *imgs.shape[1:]), cs[: n * b].reshape(n, b, -1)
    rows, hs = row_slice(b, dp), h_slice(imgs.shape[2], dp)
    return (torch.from_numpy(np.ascontiguousarray(imgs[:, rows, hs])),
            torch.from_numpy(np.ascontiguousarray(cs[:, rows])))


def _old_batches(cfg: Config, dp, items: int):
    """Host-fed batches as the port made them before under a spatial mesh:
    every model rank decodes its data index's rows and keeps its H-slice."""
    from littlegan_tpu_torch.parallel.mesh import h_slice

    data = SyntheticDataset(cfg, items)
    data.set_rows_per_batch(cfg.batch_size // dp.data_size, dp.data_rank)

    def batches(epoch, start_batch, shuffle=True):
        for img, cond in data.epoch_iterator(epoch, shuffle=shuffle, start_batch=start_batch):
            yield img[:, h_slice(img.shape[1], dp)], cond
    return batches


def store_decode(dg, case):
    """One run of ``case["cfg"]`` (``case["items"]`` synthetic items): the
    rows each batch this rank's dataset yielded after the Trainer was built
    (the fixture's batch left out), the store (device_data), the whole
    state and logged losses; and the same run with the batches made the
    old way (:func:`_old_store`, :func:`_old_batches`)."""
    from littlegan_tpu_torch.training.checkpoint import flatten_state

    cfg = rank_cfg(dg, case, "new")
    data = SpyDataset(cfg, case["items"])
    tr = logging_trainer(cfg, data, dg)
    data.yielded.clear()
    tr.train()
    store = None if tr._device_store is None else tuple(t.numpy() for t in tr._device_store)
    out = {"yielded": list(data.yielded), "store": store, "flat": flatten_state(tr.full_state()),
           "logged": tr.logged, "model_rank": tr.dp.model_rank}
    ref_cfg = rank_cfg(dg, case, "old")
    ref = logging_trainer(ref_cfg, SyntheticDataset(ref_cfg, case["items"]), tr.dp)
    if cfg.device_data:
        ref._device_store = _old_store(ref_cfg, tr.dp, case["items"])
    elif tr.dp.model_size > 1:
        ref._batches = _old_batches(ref_cfg, tr.dp, case["items"])
    ref.train()
    out.update(ref_flat=flatten_state(ref.full_state()), ref_logged=ref.logged)
    return out


def store_mismatch(dg, case):
    """The error each rank raises building the store when rank 1's dataset
    holds one batch fewer than the others' (None if none is raised)."""
    cfg = rank_cfg(dg, case, "mismatch")
    items = case["items"] - (cfg.batch_size if dg.rank == 1 else 0)
    tr = logging_trainer(cfg, SyntheticDataset(cfg, items), dg)
    try:
        tr._ensure_device_store()
    except ValueError as e:
        return str(e)
    return None


def shared_cfg(case: Dict[str, Any], name: str, **kw) -> Config:
    """``case["cfg"]`` writing under ``case["root"]/<name>``, one tree for
    every rank (the orbax backend's ranks write one checkpoint together)."""
    root = os.path.join(case["root"], name)
    return Config(**{**case["cfg"], "all_result_dir": os.path.join(root, "result"),
                     "test_data_dir": os.path.join(root, "test-data"), **kw})


def _train(dg, cfg: Config, items: int):
    """(the whole state flat after ``cfg.epoch`` epochs of a Trainer, the
    logged losses, the state flat as it was restored, the epoch it resumes
    at)."""
    from littlegan_tpu_torch.training.checkpoint import flatten_state

    tr = logging_trainer(cfg, SyntheticDataset(cfg, items), dg)
    restored = {k: np.array(v) for k, v in flatten_state(tr.full_state()).items()}
    start = tr.global_epoch
    tr.train()
    return {k: np.array(v) for k, v in flatten_state(tr.full_state()).items()}, tr.logged, restored, start


@with_shard_threshold
def ckpt_runs(dg, case):
    """On ``case["backend"]``: an unbroken run of ``case["cfg"]["epoch"]``
    epochs; the same run stopped after epoch 1 and resumed by a new
    Trainer. Returns {"unbroken", "first", "resumed": (flat, logged,
    restored flat, start epoch)}."""
    extra = {"checkpoint_backend": case["backend"]}
    epochs = case["cfg"]["epoch"]
    out = {"unbroken": _train(dg, shared_cfg(case, "unbroken", extra=extra), case["items"]),
           "first": _train(dg, shared_cfg(case, "resumed", extra=extra, epoch=1), case["items"]),
           "resumed": _train(dg, shared_cfg(case, "resumed", extra=extra, epoch=epochs), case["items"])}
    return out


@with_shard_threshold
def ckpt_restore(dg, case):
    """The whole state flat and the resume epoch of a Trainer of
    ``case["cfg"]`` that restores the orbax checkpoint under
    ``case["root"]/restore`` (written by another layout of ranks)."""
    from littlegan_tpu_torch.training.checkpoint import flatten_state

    cfg = shared_cfg(case, "restore", extra={"checkpoint_backend": "orbax"})
    tr = logging_trainer(cfg, SyntheticDataset(cfg, case["items"]), dg)
    return {k: np.array(v) for k, v in flatten_state(tr.full_state()).items()}, tr.global_epoch


def dropout_forward(dg, case):
    """D's (pr, cond) and this rank's rows of A's image, under a [1, 2]
    spatial mesh, on this rank's H-slice of ``case["image"]`` with the
    global keep-masks ``case["masks"]``."""
    import torch

    from littlegan_tpu_torch.compat.jax_params import params_from_jax
    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.parallel.mesh import h_slice, spatial_group
    from littlegan_tpu_torch.parallel.spatial import Spatial

    cfg = Config(**case["cfg"])
    sg = spatial_group(dg, (1, 2))
    model = params_from_jax(case["flat"], LittleGAN(cfg)).eval()
    x = torch.from_numpy(case["image"][:, h_slice(cfg.image_dim, sg)].copy())
    masks = [torch.from_numpy(m) for m in case["masks"]]
    sp = Spatial(sg.model)
    with torch.no_grad():
        pr, cond = model.discriminator(x, sp=sp, dropout_masks=masks)
        adj = model.adjuster(x, torch.from_numpy(case["cond"]), sp=sp, dropout_masks=masks)
    return pr.numpy(), cond.numpy(), adj.numpy()


def run_cases(dg, cases):
    """``globals()[case["fn"]](dg, case)`` of each case in turn."""
    return [globals()[case["fn"]](dg, case) for case in cases]
