"""Trainer: the host loop around the train step, the port of
littlegan_tpu/training/trainer.py.

- result tree and provenance (``config.json``, ``code.tar``);
- the pinned eval fixture (noise, cond, image) in
  ``test_data_<env>.npz`` with the reference's reuse contract;
- the epoch loop: two batches per step from the dataset's (seed, epoch)
  order, copied to the card two updates ahead (:class:`Prefetcher`: a ring
  of pinned host buffers, the copies on a side stream), per-step
  TensorBoard scalars (flushed every 16 calls in one copy
  from the card), train-sample grids every ``freq_gen`` batches, the
  fixture ``predict`` every ``freq_test``, the "Time usage ... images/s"
  line (2 x batch x grad_accum images per update), a checkpoint per epoch;
- restore of the latest checkpoint at start; SIGINT sets a flag and the
  loop saves an ``interrupt`` checkpoint at the next step (or dispatch)
  boundary with the batch it reached, then exits 1; a restart resumes at
  that batch.

Four ways through an epoch, as in the JAX trainer:

- host-fed: each step's two batches are copied from the host;
- ``grad_accum`` = M > 1, host-fed: M pairs per applied update
  (:func:`_accum_groups`);
- ``device_data``: the whole dataset (uint8, or f32 for the synthetic set)
  is uploaded once as a (n_batches, B, ...) store in the canonical order,
  and each step picks its batches by id in the epoch's
  :func:`~littlegan_tpu_torch.data.celeba.epoch_batch_order`;
- ``device_data`` with ``steps_per_dispatch`` = K > 1 or M > 1: K applied
  updates per host call, one CUDA graph replay on the card
  (``training/dispatch.py``); a trailing remainder group runs its own
  graph, cached by its size; cadences snap to group boundaries.

Each update's draws come from a ``torch.Generator`` on the card seeded from
``(cfg.seed, global_step)``, or ``(cfg.seed, global_step, j)`` for micro-step
j of an accumulated update, so a resumed or dispatched run draws what the
sequential one would have. The fixture's noise (and its image, without a
dataset) come from numpy seeded from ``cfg.seed``: other numbers than the
JAX package's ``jax.random`` streams.

Inference with the eval weights (the EMA of G's parts when the run keeps
one): ``predict`` on the fixture, ``generate``/``adjust``, and
``sample_u8``, evaluate-sample's batch as one ``inference_mode`` call with
uint8 images both in and out. ``plot`` writes ``models.txt`` and one
``.dot`` graph per network, ``export_model_checkpoint`` a weights-only npz.

With ``profile_steps`` = n > 0 one ``torch.profiler`` trace (host
activity, and the card's) of the first epoch is written under
``result/<exp>/log/profile`` (:class:`ProfileWindow`): steps [10, 10 + n)
on the one-update path; on the K-update path whole groups, from the second
group until n steps are covered. Its host side is named by
``littlegan:trainer.*`` ranges (``utils/spans.py``): ``fetch`` (the loader's
or the prefetcher's next batches, one-update path), ``draws``, ``flush``
(the losses' copy from the card) and ``cadence`` (image saves,
``gather_eval``, ``predict``), besides the step's and the graph's own.

It runs on the card unless ``device="cpu"`` is given; without a card and
without that argument it raises. It trains LittleGAN: :func:`make_trainer`
gives StarGAN v2's configs (``model = "stargan_v2"``) their own trainer,
``training/stargan_v2_trainer.py``, and StyleGAN2's (``"stylegan2"``)
``training/stylegan2_trainer.py``. Refused (``ValueError``): the meshes,
``shard_opt_state`` and ``shard_dense`` settings the JAX trainer refuses
(:func:`check_trainer_supported`).

Data parallelism (``parallel/``): under a ``torch.distributed`` process
group (``torchrun --nproc_per_node N``; :class:`~littlegan_tpu_torch.parallel.mesh.DataGroup`)
each rank trains ``batch_size / N`` rows of every global batch with the
single-card step, and the ranks average their gradients before the
optimizer (``shard_opt_state``: ZeRO-1, ``parallel/zero.py``). Every rank
draws the global batch's draws from the same seeds and keeps its rows; a
rank decodes only its rows of every batch (``set_rows_per_batch``),
host-fed and for the device store, which holds each rank's rows of every
batch. Rank 0 restores and its state
is broadcast; only rank 0 writes (result tree, fixture, checkpoints,
TensorBoard, images, traces). On the orbax backend
(``extra.checkpoint_backend = 'orbax'``, ``training/checkpoint.py::
OrbaxCheckpointer``) every rank instead saves and restores its own parts
(ZeRO-1's moment shards, ``shard_dense``'s heads) asynchronously, and the
loop waits for a save in flight before an interrupt exit, an
``epoch_callback`` and the end of ``train``. The fixture's reuse is agreed and the
fixture broadcast from rank 0; a SIGINT is agreed at every dispatch, so
the ranks save and stop together. Inference (``predict``, ``generate``,
``adjust``, ``sample_u8``) spans every visible card in one process with
``eval_data_parallel`` (``parallel/infer.py``), and each rank's own card
under a group.

A spatial mesh (``mesh_axes = ['data', 'model']``, ``mesh_shape`` [D, M],
by default [world / 2, 2]; ``parallel/spatial.py``): the ranks form a
:class:`~littlegan_tpu_torch.parallel.mesh.SpatialGroup`, each trains its
rows of every global batch and of those its H-slice, off the kernels'
route (and s2d off where block space does not tile M, as the log line
says). Model rank 0
of each data index decodes the index's rows and sends each model rank its
H-slice over a gloo group of their own (``SpatialGroup.feed_batch``),
host-fed and for the store, which holds each rank's rows and H-slice of
every batch. With ``shard_dense`` the
dense heads keep this rank's part (``parallel/zero.py``): a checkpoint and
the predict cadence gather them (every rank calls :meth:`gather_eval`).
With one process a ``('data', 'model')`` config trains unsharded, as the
JAX trainer builds a mesh only over more than one device.
"""

from __future__ import annotations

import functools
import itertools
import json
from collections import deque
import os
import signal
import sys
import threading
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from littlegan_tpu_torch.compat.jax_params import jax_key
from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.data.celeba import epoch_batch_order
from littlegan_tpu_torch.models.littlegan import LittleGAN
from littlegan_tpu_torch.ops.losses import mean_squared_error
from littlegan_tpu_torch.parallel.infer import data_parallel_infer, infer_mesh_devices
from littlegan_tpu_torch.parallel.mesh import (
    DataGroup, SpatialGroup, check_mesh, check_spatial, data_group, row_slice,
    spatial_group,
)
from littlegan_tpu_torch.parallel.spatial import resolve_config
from littlegan_tpu_torch.parallel.train import GradSync, global_rows, local_draws, replicate_state
from littlegan_tpu_torch.parallel.zero import (
    Zero1, check_shard_dense, check_shard_opt_state, dense_whole_state, shard_dense_state, state_parts,
)
from littlegan_tpu_torch.training.checkpoint import OrbaxCheckpointer, make_checkpointer
from littlegan_tpu_torch.training.state import TrainState, create_train_state, eval_params
from littlegan_tpu_torch.training.step import (
    LOSS_KEYS, draw_step, make_accum_train_step, make_gather_train_step,
    make_scan_accum_train_step, make_scan_train_step, make_train_step, stack_draws,
)
from littlegan_tpu_torch.utils.device import resolve_device
from littlegan_tpu_torch.utils.image import (
    data_rescale, ensure_pm1, inverse_rescale, save_image, soft, to_grid,
)
from littlegan_tpu_torch.utils.provenance import init_result_dirs, snapshot_run
from littlegan_tpu_torch.utils.spans import span
from littlegan_tpu_torch.utils.tensorboard import SummaryWriter

FLUSH_EVERY = 16  # calls whose losses stay on the card before one copy to the host


def check_trainer_supported(cfg: Config, dp: Optional[DataGroup] = None) -> None:
    """Refuse a mesh the JAX trainer's ``make_mesh`` refuses over the ranks of
    ``dp`` (a :class:`SpatialGroup` for ``['data', 'model']``),
    ``shard_dense`` without a model axis dividing ``init_dim``, and
    ``shard_opt_state`` without ranks to shard over; the data ranks must
    split ``batch_size`` and the model ranks ``image_dim``."""
    if cfg.model != "littlegan":
        raise ValueError(f"Trainer trains LittleGAN; model {cfg.model!r} trains with make_trainer's choice "
                         "(stargan_v2: training/stargan_v2_trainer.py, stylegan2: "
                         "training/stylegan2_trainer.py)")
    world = 1 if dp is None else dp.world
    check_mesh(cfg.mesh_axes, cfg.mesh_shape, world)
    check_shard_dense(cfg, dp)
    check_shard_opt_state(cfg, dp)
    if isinstance(dp, SpatialGroup):
        check_spatial(cfg, (dp.data_size, dp.model_size))
    elif cfg.batch_size % world:
        raise ValueError(
            f"data-parallel training needs batch_size ({cfg.batch_size}) divisible by the {world} ranks: "
            f"as configured, {world} processes would not split one global batch"
        )


def _on_device(fn, device: torch.device):
    """``fn(model, *arrays)`` on one device, with the call signature of
    :func:`data_parallel_infer`'s wrappers (a ``version`` it has no use for)."""
    def call(model, *args, version=None):
        with torch.inference_mode():
            return fn(model, *((torch.from_numpy(a) if isinstance(a, np.ndarray) else a).to(device) for a in args))
    return call


def _generate(model, noise, cond):
    return model.generator(noise, cond).float()


def _discriminate(model, image):
    return model.discriminator(image)


def _adjust(model, image, cond):
    return model.adjuster(image, cond).float()


def _quantize(y: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 as ``clip(round((y + 1) * 127.5), 0, 255)`` (round half to even)."""
    return torch.clamp(torch.round((y.float() + 1.0) * 127.5), 0, 255).to(torch.uint8)


def _sample(model, noise, cond, image_u8, train_adj: bool):
    """sample_u8's batch: (uint8 G images, D's four scores[, uint8 adjusted real, generated])."""
    img = data_rescale(image_u8.float())
    gen = model.generator(noise, cond).float()
    out = (_quantize(gen), *model.discriminator(img), *model.discriminator(gen))
    if train_adj:
        out += (_quantize(model.adjuster(img, cond)), _quantize(model.adjuster(gen, cond)))
    return out


def _pairwise(it):
    """Two batches per step; a trailing odd batch is dropped."""
    while True:
        try:
            b1 = next(it)
            b2 = next(it)
        except StopIteration:
            return
        yield b1, b2


def _accum_groups(pairs, m: int):
    """Stack ``m`` host (batch1, batch2) pairs into (M, B, ...) numpy arrays
    for the accumulation step; a trailing partial group is dropped."""
    while True:
        chunk = list(itertools.islice(pairs, m))
        if len(chunk) < m:
            return
        yield tuple(tuple(np.stack([np.asarray(c[i][j]) for c in chunk]) for j in range(2)) for i in range(2))


class Prefetcher:
    """Host batches onto the device ``depth`` updates ahead, the port of the
    JAX trainer's ``_device_prefetch`` / ``_accum_prefetch``.

    Each item is ((images, conds), (images, conds)) of numpy arrays: a
    step's two batches, or two (M, B, ...) accumulation stacks. On the card
    each array is written into a ring of ``depth`` pinned host buffers and
    copied to a fresh device tensor with ``non_blocking`` on a side stream,
    which records an event; the step's stream waits on that event when the
    item is taken. A pinned buffer is written again only after the event of
    its last copy has completed, since a copy still reading it would carry
    the next batch's bytes. On the CPU the arrays become tensors without a
    copy."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device, self.depth = device, depth
        self.cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        self._slots: list = [None] * depth  # per ring slot: (pinned buffers, event of their last copy)

    @staticmethod
    def _arrays(item) -> list:
        return [np.ascontiguousarray(a, np.float32 if j == 1 else None) for b in item for j, a in enumerate(b)]

    def _put(self, item, slot: int):
        arrays = self._arrays(item)
        if not self.cuda:
            return [torch.from_numpy(a) for a in arrays], None
        pinned, event = self._slots[slot] or (None, None)
        if event is not None:
            event.synchronize()  # the slot's last copy has read its buffers
        if pinned is None or [p.shape for p in pinned] != [a.shape for a in arrays] \
                or [p.numpy().dtype for p in pinned] != [a.dtype for a in arrays]:
            pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
        else:
            for p, a in zip(pinned, arrays):
                p.numpy()[...] = a
        with torch.cuda.stream(self._stream):
            out = [torch.empty(p.shape, dtype=p.dtype, device=self.device) for p in pinned]
            for d, p in zip(out, pinned):
                d.copy_(p, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slots[slot] = (pinned, event)
        return out, event

    def _take(self, entry):
        tensors, event = entry
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:  # allocated on the side stream, freed after the step's use
                t.record_stream(stream)
        return (tensors[0], tensors[1]), (tensors[2], tensors[3])

    def __call__(self, items: Iterable) -> Iterator:
        buf: deque = deque()
        for i, item in enumerate(items):
            buf.append(self._put(item, i % self.depth))
            if len(buf) == self.depth:
                yield self._take(buf.popleft())
        while buf:
            yield self._take(buf.popleft())


class ProfileWindow:
    """One ``torch.profiler`` trace per run, written under
    ``result/<exp>/log/profile`` in TensorBoard's PyTorch profiler format
    (JAX ``trainer.py:794-799``): host activity, and the card's on a CUDA
    device. The device is synchronised before the start and the stop, so
    the window holds the work of its own steps only."""

    def __init__(self, cfg: Config, device: torch.device):
        self.dir = os.path.join(cfg.result_dir, "log", "profile")
        self.steps = cfg.profile_steps
        self.device = device
        self.started = False
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        self._sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(self.dir))
        self._prof.start()
        self.started = True

    def stop(self) -> None:
        self._sync()
        self._prof.stop()
        self._prof = None
        print("profiler trace written to", self.dir)


def d_score_stats(cond, real_pr, real_c, fake_pr, fake_c) -> Dict:
    """The predict-mode D-score payload: rounded percentage score lists and
    MSE against the softened targets."""
    arr = lambda t: np.asarray(t.float().cpu() if isinstance(t, torch.Tensor) else t, np.float32)  # noqa: E731
    save: Dict = {"real_cond": arr(cond), "real_pr": arr(real_pr), "real_c": arr(real_c),
                  "fake_pr": arr(fake_pr), "fake_c": arr(fake_c)}
    mse = lambda t, p: float(mean_squared_error(t, torch.from_numpy(p)).mean())  # noqa: E731
    save["real_pr_mse"] = mse(soft(1.0), save["real_pr"])
    save["real_c_mse"] = mse(save["real_cond"], save["real_c"])
    save["fake_pr_mse"] = mse(soft(0.0), save["fake_pr"])
    save["fake_c_mse"] = mse(save["real_cond"], save["fake_c"])
    for key in ("real_cond", "real_pr", "real_c", "fake_c", "fake_pr"):
        save[key] = np.round(save[key] * 100).astype(int).tolist()
    return save


def step_seed(seed: int, global_step: int, micro: Optional[int] = None) -> int:
    """The seed of step ``global_step``'s draws, or of its micro-step
    ``micro`` in an accumulated update."""
    entropy = [seed, global_step] if micro is None else [seed, global_step, micro]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


MODELS = ("littlegan", "stargan_v2", "stylegan2")


def make_trainer(cfg: Config, dataset, device=None, group: Optional[DataGroup] = None):
    """The trainer of ``cfg.model``: :class:`Trainer` for LittleGAN,
    ``StarGANTrainer`` (``training/stargan_v2_trainer.py``, one process,
    no group) for StarGAN v2, ``StyleGAN2Trainer``
    (``training/stylegan2_trainer.py``, the same) for StyleGAN2."""
    if cfg.model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {cfg.model!r}")
    if cfg.model == "stargan_v2":
        if group is not None:
            raise ValueError("model stargan_v2 trains on one card: start it without torchrun")
        from littlegan_tpu_torch.training.stargan_v2_trainer import StarGANTrainer

        return StarGANTrainer(cfg, dataset, device=device)
    if cfg.model == "stylegan2":
        if group is not None:
            raise ValueError("model stylegan2 trains on one card: start it without torchrun")
        from littlegan_tpu_torch.training.stylegan2_trainer import StyleGAN2Trainer

        return StyleGAN2Trainer(cfg, dataset, device=device)
    return Trainer(cfg, dataset, device=device, group=group)


class Trainer:
    def __init__(self, cfg: Config, dataset=None, device=None, group: Optional[DataGroup] = None):
        """``group``: this rank's data-parallel group; default: the running
        process group's (:func:`~littlegan_tpu_torch.parallel.mesh.data_group`,
        on ``device``), None when none runs. With ``mesh_axes =
        ['data', 'model']`` the group's ranks are made a spatial mesh of
        ``mesh_shape`` (a collective)."""
        self.dp = group if group is not None else data_group(device)
        if self.dp is not None and tuple(cfg.mesh_axes) == ("data", "model") and not isinstance(self.dp, SpatialGroup):
            self.dp = spatial_group(self.dp, cfg.mesh_shape)
        check_trainer_supported(cfg, self.dp)
        self.cfg = cfg
        self.dataset = dataset
        self.device = self.dp.device if self.dp is not None else resolve_device(device)
        self.writes = self.dp is None or self.dp.rank == 0  # only rank 0 writes files
        if self.writes:
            init_result_dirs(cfg)
            snapshot_run(cfg)
        self.state: TrainState = create_train_state(cfg, self.device)
        self.global_epoch = 1
        self.global_step = 0
        self._resume_batch = 0  # mid-epoch resume point (interrupt checkpoints only)
        self._cur_batch_no = 0  # batches completed in the current epoch
        self.checkpointer = make_checkpointer(cfg, os.path.join(cfg.result_dir, "checkpoint"), self.dp)
        # the orbax backend: every rank saves and restores its own parts; npz: rank 0 the whole state
        self._rank_saves = isinstance(self.checkpointer, OrbaxCheckpointer)
        status = {}
        if cfg.restore and self.writes and not self._rank_saves:
            restored, status = self.checkpointer.restore_latest(self.state)
            if restored is not None:
                print("Restored checkpoint", self.checkpointer.latest_tag())
        if self.dp is not None:  # rank 0's restored (or fresh) state on every rank
            status = self.dp.broadcast_object(status)
            replicate_state(self.state, self.dp)
        self._sync: Optional[GradSync] = None
        if self.dp is not None:
            if cfg.shard_dense:  # after the restore and the broadcast of the whole state
                shard_dense_state(self.state, self.dp)
            self._sync = (Zero1(self.dp, self.state, cfg.shard_dense) if cfg.shard_opt_state
                          else GradSync(self.dp, cfg.shard_dense))
        self._parts = state_parts(self._sync, self.state)  # the leaves this rank holds a part of
        if cfg.restore and self._rank_saves:  # into the parts, on every rank
            restored, status = self.checkpointer.restore_latest(self.state, self._parts)
            if restored is not None and self.writes:
                print("Restored checkpoint", self.checkpointer.latest_tag())
        self.global_epoch = int(status.get("epoch", 1))
        self.global_step = int(status.get("step", 0))
        self._resume_batch = int(status.get("batch", 0))
        self._writer: Optional[SummaryWriter] = None
        self._metrics_buffer = []
        self._flushing = False
        self._interrupt_requested = False
        self._nonfinite_warned = False
        self._in_train = False
        self._pinned_tags: set = set()
        self._device_store: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._scan_steps: Dict[int, object] = {}  # K -> K-update step (one CUDA graph each)
        self._eval_model: Optional[LittleGAN] = None  # see eval_model
        self._dense_eval: Optional[Tuple[int, LittleGAN]] = None  # shard_dense: (version, whole eval model)
        self._version = 0  # counts the weight updates: the inference replicas' cache key
        self._init_fixture()
        if self.dp is not None and dataset is not None:
            self._decode_rows_only(dataset)
        if cfg.grad_accum > 1 and getattr(dataset, "batches", None) is not None \
                and dataset.batches < 2 * cfg.grad_accum:
            print(f"WARNING: dataset has {dataset.batches} batches but one accumulation group consumes "
                  f"{2 * cfg.grad_accum}; every epoch would apply ZERO updates. Lower grad_accum or grow "
                  "the dataset.")
        self._train_step = make_train_step(cfg, self.state, self._sync)
        self._accum_step = make_accum_train_step(cfg, self.state, self._sync)
        self._gather_step = make_gather_train_step(cfg, self.state, sync=self._sync)
        if isinstance(self.dp, SpatialGroup):
            shape = {"data": self.dp.data_size, "model": self.dp.model_size}
            note = resolve_config(cfg, self.dp.model_size)[1]
            if self.dp.model_size == 1:
                note = "a model axis of 1 holds whole maps: the data-parallel step"
            if cfg.grad_accum > 1:
                print(f"Spatially-sharded training with {cfg.grad_accum}-pair gradient accumulation (effective batch "
                      f"{cfg.grad_accum * cfg.batch_size})")
            print(f"Spatially-sharded training over a {shape} mesh" + (f" ({note})" if note else ""))
        elif self.dp is not None:
            n = self.dp.world
            if cfg.grad_accum > 1:
                print(f"Data-parallel training over {n} devices with {cfg.grad_accum}-pair gradient accumulation "
                      f"(effective batch {cfg.grad_accum * cfg.batch_size})")
            else:
                print(f"Data-parallel training over {n} devices")
        self._generator = torch.Generator(device=self.device)
        self._prefetch = Prefetcher(self.device)
        self._profile: Optional[ProfileWindow] = None  # the run's window (profile_steps), made in train()
        if cfg.eval_data_parallel and self.dp is None and infer_mesh_devices(self.device) > 1:
            wrap = data_parallel_infer  # every visible card
        else:
            wrap = lambda fn, n: _on_device(fn, self.device)  # noqa: E731
        self._gen = wrap(_generate, 2)
        self._disc = wrap(_discriminate, 1)
        self._adj = wrap(_adjust, 2)
        self._sample = wrap(functools.partial(_sample, train_adj=cfg.train_adj), 3)

    def _decode_rows_only(self, dataset) -> None:
        """Under a group, a rank decodes only its data index's rows of every
        batch (``set_rows_per_batch``), host-fed and for the device store
        alike; under a spatial mesh only model rank 0 of each data index
        decodes, and sends each model rank its H-slice (:meth:`_fed`)."""
        cfg, dp = self.cfg, self.dp
        if not hasattr(dataset, "set_rows_per_batch"):
            raise ValueError("data parallelism needs a dataset with set_rows_per_batch (CelebA and "
                             "SyntheticDataset have it): each rank decodes its own rows of every batch")
        rows = cfg.batch_size // dp.data_size
        where = "device_data" if cfg.device_data else "host-fed"
        if dp.model_size == 1:
            dataset.set_rows_per_batch(rows, dp.data_rank)
            print(f"data-parallel {where}: each rank decodes {rows}/{cfg.batch_size} rows per batch (its own slice)")
            return
        if dp.model_rank == 0:
            dataset.set_rows_per_batch(rows, dp.data_rank)
        print(f"spatial {where}: model rank 0 of each data index decodes its {rows}/{cfg.batch_size} rows per "
              f"batch and sends each of the {dp.model_size} model ranks its H-slice")

    # ---------------------------------------------------------- fixture ----

    def _init_fixture(self) -> None:
        """The pinned (noise, cond, image) eval triplet, reused from
        ``test_data_<env>.npz`` when ``cfg.reuse`` and the file exists,
        else made anew and written there atomically. Under data
        parallelism the ranks agree to reuse only if every rank sees the
        file, rank 0 makes or reads the triplet and broadcasts it, and only
        rank 0 writes."""
        cfg = self.cfg
        npz = os.path.join(cfg.test_data_dir, f"test_data_{cfg.env}.npz")
        reuse = cfg.reuse and os.path.isfile(npz)
        if self.dp is not None:
            reuse = self.dp.all(reuse)
            triplet = self._fixture(npz, reuse) if self.dp.rank == 0 else None
            noise, cond, image = self.dp.broadcast_object(triplet)
        else:
            noise, cond, image = self._fixture(npz, reuse)
        self.test_noise, self.test_cond, self.test_image = noise, cond, image
        if not reuse and self.writes:
            os.makedirs(cfg.test_data_dir, exist_ok=True)
            tmp = npz + ".tmp"
            with open(tmp, "wb") as f:
                np.savez_compressed(f, n=noise, c=cond, i=image)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, npz)

    def _fixture(self, npz: str, reuse: bool):
        """(noise, cond, image): read from ``npz``, or made anew."""
        cfg = self.cfg
        if reuse:
            data = np.load(npz)
            noise, cond, image = (data[k].astype(np.float32) for k in ("n", "c", "i"))
        else:
            rng = np.random.default_rng((cfg.seed, 1))
            if self.dataset is not None:
                image, cond = next(self.dataset.epoch_iterator(0))
                image = ensure_pm1(image)
            else:
                image = rng.uniform(-1, 1, (cfg.batch_size, *cfg.image_shape)).astype(np.float32)
                bits = np.random.default_rng(cfg.seed).random((cfg.batch_size, cfg.cond_dim)) < 0.5
                cond = soft(np.where(bits, -1.0, 1.0)).astype(np.float32)
            noise = rng.standard_normal((cond.shape[0], cfg.noise_dim)).astype(np.float32)
        return noise, cond, image

    # ------------------------------------------------------------- train ----

    def draws(self, global_step: int, micro: Optional[int] = None):
        """The draws of step ``global_step`` (or of its micro-step ``micro``):
        the global batch's, of which a data-parallel rank keeps its rows."""
        self._generator.manual_seed(step_seed(self.cfg.seed, global_step, micro))
        return local_draws(draw_step(self._generator, self.cfg, self.cfg.batch_size, self.device), self.dp)

    def update_draws(self, global_step: int):
        """The draws of the update at ``global_step``: today's step draws,
        or with ``grad_accum`` = M > 1 its M micro-steps' stacked."""
        m = self.cfg.grad_accum
        if m == 1:
            return self.draws(global_step)
        return stack_draws([self.draws(global_step, j) for j in range(m)])

    # ---------------------------------------------------- device store ----

    def _ensure_device_store(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Upload the whole dataset to the card once (``cfg.device_data``):
        images as the dataset yields them (uint8; f32 for the synthetic
        set) and f32 conditions, reshaped to (n_batches, B, ...). Row j is
        batch j of the canonical (unshuffled) order, so an epoch's
        :func:`epoch_batch_order` reproduces the host pipeline's batch
        sequence. A data-parallel rank holds its rows of every batch (the
        JAX package's ``P(None, 'data')`` store), which its dataset alone
        decodes; a spatial rank its rows' H-slice (``P(None, 'data',
        'model')``), sent by model rank 0 of its data index, so the
        per-step gather stays on its card. Every rank must hold the
        dataset's global batch count (``dataset.batches``) of its rows: the
        ranks agree on it before the first collective of a step, and raise
        together where one differs."""
        if self._device_store is None:
            cache = getattr(self.dataset, "_cache", None)  # a decode cache is dead weight here
            if cache is not None:
                self.dataset._cache = None
            try:
                batches = list(self._batches(0, 0, shuffle=False))
            finally:
                if cache is not None:
                    self.dataset._cache = cache
            rows = row_slice(self.cfg.batch_size, self.dp)
            n = len(batches)
            imgs = np.stack([b[0] for b in batches]) if n else np.zeros((0, 0), np.float32)
            cs = np.stack([b[1] for b in batches]).astype(np.float32) if n else np.zeros((0, 0), np.float32)
            del batches
            self._check_store(imgs, rows.stop - rows.start)
            print(f"device_data: uploading {imgs.nbytes / 1e9:.2f} GB {imgs.dtype} dataset "
                  f"({n} batches{'' if self.dp is None else f', rows {rows.start}-{rows.stop - 1} of each'}) "
                  f"to {self.device}")
            self._device_store = (torch.from_numpy(imgs).to(self.device), torch.from_numpy(cs).to(self.device))
        return self._device_store

    def _check_store(self, imgs: np.ndarray, rows: int) -> None:
        """The store's (n_batches, rows, ...) against the dataset's global
        batch count (JAX ``trainer.py:560-575``), and under a group against
        rank 0's: a rank that differs raises on every rank, before any step
        could wait for it in a collective."""
        n = imgs.shape[0]
        ok = imgs.ndim > 1 and imgs.shape[1] == rows
        expected = getattr(self.dataset, "batches", None)
        if expected is not None:
            ok = ok and n == expected
        if self.dp is None:
            if not ok:
                raise ValueError(f"device_data: the dataset yielded {n} batches of {rows} rows, expected "
                                 f"{expected} (dataset.batches)")
            return
        n0 = self.dp.broadcast_object(n)
        if self.dp.any(not ok or n != n0):
            raise ValueError(f"device_data: rank {self.dp.rank} holds {n} batches of its {rows} rows, rank 0 {n0}, "
                             f"expected {expected} (dataset.batches): every rank's dataset must yield the global "
                             "batch count")

    def _device_epoch(self, epoch: int) -> Iterator[int]:
        """Batch ids into the store, in the epoch's order: the same
        (seed, epoch) stream as the host pipeline's."""
        imgs, _ = self._ensure_device_store()
        for b in epoch_batch_order(self.cfg.seed, epoch, imgs.shape[0]):
            yield int(b)

    def _scan_step(self, k: int):
        """The K-update step (cached by K, so the trailing remainder group
        captures its graph once)."""
        if k not in self._scan_steps:
            make = make_scan_accum_train_step if self.cfg.grad_accum > 1 else make_scan_train_step
            self._scan_steps[k] = make(self.cfg, self.state, k, sync=self._sync)
        return self._scan_steps[k]

    def _uses_scan(self) -> bool:
        cfg = self.cfg
        return cfg.device_data and (cfg.steps_per_dispatch > 1 or cfg.grad_accum > 1)

    def full_state(self) -> TrainState:
        """The train state with every moment and dense head whole (ZeRO-1
        and ``shard_dense`` gather their parts: every rank calls this at the
        same point)."""
        return self.state if self._sync is None else self._sync.full_state(self.state)

    def _interrupted(self) -> bool:
        """Whether a SIGINT arrived on this rank, or on any rank under data
        parallelism (one host all-reduce: the ranks stop together)."""
        return self._interrupt_requested if self.dp is None else self.dp.any(self._interrupt_requested)

    @property
    def writer(self) -> SummaryWriter:
        if self._writer is None:
            self._writer = SummaryWriter(os.path.join(self.cfg.result_dir, "log"))
        return self._writer

    def _request_interrupt(self, signum=None, frame=None):
        """SIGINT handler: set a flag only; the loop checkpoints at its next
        step boundary. A second Ctrl-C aborts at once, without a checkpoint."""
        if self._interrupt_requested:
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt
        self._interrupt_requested = True
        os.write(2, b"\nSIGINT: checkpointing at the next step boundary "
                    b"(Ctrl-C again to abort without a checkpoint)\n")

    def _save(self, tag: str, status: Dict) -> None:
        """Checkpoint ``tag``: on the orbax backend every rank saves its own
        parts (asynchronously); on npz rank 0 the whole state, gathered."""
        if self._rank_saves:
            self.checkpointer.save(tag, self.state, status, parts=self._parts)
            return
        state = self.full_state()
        if self.writes:
            self.checkpointer.save(tag, state, status)

    def _save_interrupt(self):
        self._flush_buffered()
        if self.writes:
            self.writer.flush()
        self._save("interrupt", {"epoch": self.global_epoch, "step": self.global_step, "batch": self._cur_batch_no})
        self.checkpointer.wait()
        print("\nCheckpoint has been saved (interrupt)")
        sys.exit(1)

    def _save_epoch_checkpoint(self, epoch: int) -> None:
        cfg = self.cfg
        if cfg.ckpt_every > 1 and epoch % cfg.ckpt_every != 0 and epoch != cfg.epoch:
            return
        self._save(str(epoch), {"epoch": epoch + 1, "step": self.global_step})
        if cfg.keep_checkpoints > 0:
            if self._rank_saves and self.dp is not None:  # no rank still reads what rank 0 deletes
                self.dp.barrier()
            if self.writes:
                self._prune_checkpoints(cfg.keep_checkpoints)

    def _prune_checkpoints(self, keep: int) -> None:
        """Drop all but the newest ``keep`` epoch checkpoints, except pinned
        ones; after a non-finite loss nothing is dropped, so the
        pre-divergence epochs stay on disk."""
        if self._nonfinite_warned:
            return
        for tag in self.checkpointer.epoch_tags()[:-keep]:
            if int(tag) not in self._pinned_tags:
                self.checkpointer.delete(tag)

    def pin_checkpoint(self, tag) -> None:
        """Exempt an epoch checkpoint from pruning (an eval-driven caller
        keeping its best epoch). Pins live in this Trainer only: a resumed
        run starts with none."""
        self._pinned_tags.add(int(tag))

    def unpin_checkpoint(self, tag) -> None:
        """Drop a pin; the tag is prunable again at the next rotation."""
        self._pinned_tags.discard(int(tag))

    def train(self, epoch_callback=None) -> None:
        """Train from the restored epoch to ``cfg.epoch``.

        ``epoch_callback(epoch)``, when given, runs after each epoch's
        checkpoint is written (and pruned); with ``ckpt_every > 1`` it still
        runs every epoch. Its exceptions propagate and end the run, the
        epoch's checkpoint being on disk already."""
        cfg = self.cfg
        if self.dataset is None:
            raise ValueError("train mode needs a dataset")
        if cfg.steps_per_dispatch > 1 and not cfg.device_data:
            print("WARNING: steps_per_dispatch > 1 requires device_data=True (the card-resident "
                  "dataset); running one step per dispatch.")
        if self._uses_scan() and cfg.grad_accum > 1:
            print(f"device_data x grad_accum: {cfg.grad_accum} micro-pairs per update (effective batch "
                  f"{cfg.grad_accum * cfg.batch_size}), {cfg.steps_per_dispatch} updates per dispatch")
        self._interrupt_requested = False
        self._in_train = True
        main = threading.current_thread() is threading.main_thread()
        prev_handler = signal.signal(signal.SIGINT, self._request_interrupt) if main else None
        self._metrics_buffer = []
        first_epoch = self.global_epoch
        self._profile = ProfileWindow(cfg, self.device) if cfg.profile_steps > 0 and self.writes else None
        try:
            for epoch in range(self.global_epoch, cfg.epoch + 1):
                self.global_epoch = epoch
                print(f"Experiment: {cfg.exp_name} Epoch: {epoch} starting...")
                start = time.time()
                resume_b = self._resume_batch if epoch == first_epoch else 0
                if resume_b:
                    print(f"mid-epoch resume: continuing epoch {epoch} at batch {resume_b + 1} "
                          f"(skipping {resume_b} already-trained batches)")
                run = self._scan_epoch if self._uses_scan() else self._step_epoch
                images_done, dropped = run(epoch, resume_b, epoch == first_epoch)
                if self._profile is not None and self._profile.active:  # a short first epoch: stop at its end
                    self._profile.stop()
                self._flush_buffered()
                elapsed = time.time() - start
                rate = images_done / elapsed if elapsed > 0 else 0.0
                note = f"  [{dropped} trailing batch(es) dropped]" if dropped else ""
                print(f"Time usage: {elapsed:.1f}s  ({rate:.1f} images/s){note}")
                self._save_epoch_checkpoint(epoch)
                if self._interrupted():
                    self._save_interrupt()
                if epoch_callback is not None:
                    self.checkpointer.wait()  # the callback sees the epoch's checkpoint complete
                    epoch_callback(epoch)
        finally:
            self.checkpointer.wait()  # the save in flight, and the status with it
            self._in_train = False
            if main:
                signal.signal(signal.SIGINT, prev_handler)
            if self._writer is not None:
                self._writer.flush()

    def _batches(self, epoch: int, start_batch: int, shuffle: bool = True) -> Iterator:
        """The dataset's (images, conds) batches of ``epoch`` (this rank's
        rows); under a spatial mesh model rank 0 of the data index decodes
        them and each model rank receives its H-slice (:meth:`_fed`)."""
        if self.dp is None or self.dp.model_size == 1:
            return self.dataset.epoch_iterator(epoch, shuffle=shuffle, start_batch=start_batch)
        it = self.dataset.epoch_iterator(epoch, shuffle=shuffle, start_batch=start_batch) \
            if self.dp.model_rank == 0 else None
        return self._fed(it)

    def _fed(self, it: Optional[Iterator]) -> Iterator:
        """Each batch of ``it`` (model rank 0's; None on the other model
        ranks) as this rank's H-slice of the images and the whole conds,
        over the data index's feed group. Every rank takes as many items
        as the others (the steps are the same), and model rank 0 ends the
        feed for all when ``it`` is done."""
        while True:
            got = self.dp.feed_batch(None if it is None else next(it, None))
            if got is None:
                return
            yield got

    def _step_epoch(self, epoch: int, resume_b: int, first: bool = False) -> Tuple[int, int]:
        """One applied update per call: host-fed, host-fed accumulation or
        the gather step over the device store; ``first``: the run's first
        epoch, where the profile window lies. Returns (images, 0)."""
        cfg = self.cfg
        m = cfg.grad_accum
        if cfg.device_data:  # M == 1 here: accumulation over the store rides the scan path
            imgs, conds = self._ensure_device_store()
            ids = self._device_epoch(epoch)
            for _ in range(2 * resume_b):
                next(ids, None)
            updates = _pairwise(ids)

            def run(b1, b2, draws, batch_no):
                return self._gather_step(self.state, imgs, conds, b1, b2, draws, batch_no)
        elif m > 1:
            updates = self._prefetch(
                _accum_groups(_pairwise(self._batches(epoch, 2 * m * resume_b)), m))

            def run(b1, b2, draws, batch_no):
                return self._accum_step(self.state, b1, b2, draws, batch_no)
        else:
            updates = self._prefetch(_pairwise(self._batches(epoch, 2 * resume_b)))

            def run(b1, b2, draws, batch_no):
                return self._train_step(self.state, b1, b2, draws, batch_no)

        batch_no = resume_b
        self._cur_batch_no = batch_no
        images_done = 0
        prof = self._profile if first else None
        updates = iter(updates)
        while True:
            with span("trainer.fetch"):  # the loader's or the prefetcher's next batches
                pair = next(updates, None)
            if pair is None:
                break
            b1, b2 = pair
            batch_no += 1
            self._cur_batch_no = batch_no
            self.global_step += 1
            if prof is not None:  # steps [10, 10 + n) of the first epoch
                if batch_no == 10 and not prof.started:
                    prof.start()
                elif prof.active and batch_no == 10 + prof.steps:
                    prof.stop()
            with span("trainer.draws"):
                draws = self.update_draws(self.global_step)
            out = run(b1, b2, draws, batch_no)
            self._metrics_buffer.append((self.global_step, batch_no, out.metrics))
            images_done += 2 * cfg.batch_size * m
            self._after_dispatch(out, epoch, batch_no - 1, batch_no)
        return images_done, 0

    def _scan_epoch(self, epoch: int, resume_b: int, first: bool = False) -> Tuple[int, int]:
        """K applied updates per call over the device store, each of M
        micro-pairs; the trailing partial group runs as a smaller one.
        Returns (images, trailing batches dropped)."""
        cfg = self.cfg
        k, m = cfg.steps_per_dispatch, cfg.grad_accum
        per_update = 2 * m
        imgs, conds = self._ensure_device_store()
        ids = self._device_epoch(epoch)
        for _ in range(per_update * resume_b):
            next(ids, None)
        batch_no = resume_b
        self._cur_batch_no = batch_no
        images_done = dropped = 0
        prof = self._profile if first else None
        while True:
            group = list(itertools.islice(ids, per_update * k))
            k_r = len(group) // per_update
            if k_r < k:  # the trailing partial group: only a partial update's batches drop
                dropped = len(group) - per_update * k_r
                if k_r == 0:
                    break
                group = group[: per_update * k_r]
            if prof is not None:
                # whole groups: skip the first (warm-up), trace until n steps are
                # covered; an epoch whose second group is its remainder is traced
                if not prof.started and (batch_no >= k or k_r < k):
                    prof.start()
                elif prof.active and batch_no >= k + prof.steps:
                    prof.stop()
            # pair p = (group[2p], group[2p + 1]); update u takes pairs [u*M, (u+1)*M)
            b1 = np.asarray(group[0::2], np.int64).reshape(k_r, m)
            b2 = np.asarray(group[1::2], np.int64).reshape(k_r, m)
            if m == 1:
                b1, b2 = b1[:, 0], b2[:, 0]
            with span("trainer.draws"):
                draws = stack_draws([self.update_draws(self.global_step + 1 + i) for i in range(k_r)])
            out = self._scan_step(k_r)(self.state, imgs, conds, b1, b2, draws, batch_no + 1)
            self._metrics_buffer.append((self.global_step + 1, batch_no + 1, out.metrics))
            prev = batch_no
            batch_no += k_r
            self._cur_batch_no = batch_no
            self.global_step += k_r
            images_done += 2 * cfg.batch_size * k_r * m
            self._after_dispatch(out, epoch, prev, batch_no)
            if k_r < k:
                break
        return images_done, dropped

    def _after_dispatch(self, out, epoch: int, prev_batch: int, batch_no: int) -> None:
        """Between two calls: flush the losses every FLUSH_EVERY calls, the
        cadences (once if any update of the call crossed one: group-snapped
        on the scan path) and a deferred SIGINT."""
        cfg = self.cfg
        self._version += 1
        if len(self._metrics_buffer) >= FLUSH_EVERY:
            with span("trainer.flush"):  # one copy from the card, which drains its queue
                self._flush_buffered()
        if cfg.freq_gen > 0 and batch_no // cfg.freq_gen > prev_batch // cfg.freq_gen:
            with span("trainer.cadence"):
                self._save_train_images(out, epoch, batch_no)
        if cfg.freq_test > 0 and batch_no // cfg.freq_test > prev_batch // cfg.freq_test:
            with span("trainer.cadence"):
                self.gather_eval()
                if self.writes:
                    name = f"{epoch}-{batch_no}"
                    self.predict(
                        self.test_noise, self.test_cond, self.test_image,
                        os.path.join(cfg.result_dir, "test", "gen", f"{name}.jpg"),
                        os.path.join(cfg.result_dir, "test", "disc", f"{name}.json"),
                        os.path.join(cfg.result_dir, "test", "adj", f"{name}.jpg"),
                    )
        if self._interrupted():
            self._save_interrupt()

    def _save_train_images(self, out, epoch: int, batch_no: int) -> None:
        """The last update's G (and adjuster) images as grids, the global
        batch's rows gathered from every rank (a collective)."""
        cfg = self.cfg
        base = os.path.join(cfg.result_dir, "train")
        fake = global_rows(out.fake_image, self.dp)
        adj = global_rows(out.adj_image, self.dp, halves=not cfg.adj_half_batch) if cfg.train_adj else None
        if not self.writes:
            return
        save_image(fake.float().cpu().numpy(), os.path.join(base, "gen", f"{epoch}-{batch_no}.jpg"))
        if adj is not None:
            save_image(adj.float().cpu().numpy(), os.path.join(base, "adj", f"{epoch}-{batch_no}.jpg"))

    def _flush_buffered(self) -> None:
        """Write the buffered losses to TensorBoard (one copy from the card)
        and print the last; reentrancy-safe. With ``halt_on_nonfinite`` a
        diverged run stops here."""
        if self._flushing or not self._metrics_buffer:
            return
        self._flushing = True
        try:
            buf = self._metrics_buffer  # (first step, its batch_no, 0-dim or (K,) losses) per call
            per_call = [torch.stack([torch.atleast_1d(m[k]) for k in LOSS_KEYS], 1) for _, _, m in buf]
            host = torch.cat(per_call).cpu().tolist()
            steps = [(s0 + i, b0 + i) for (s0, b0, _), t in zip(buf, per_call) for i in range(t.shape[0])]
            for (step, batch_no), (g, d, a) in zip(steps, host):
                pairs = [("loss/gen", g), ("loss/disc", d)]
                if self.cfg.train_adj and batch_no > 10:  # no adj loss in the warm-up window
                    pairs.append(("loss/adj", a))
                if self.writes:
                    self.writer.scalars(pairs, step)
                if not self._nonfinite_warned and not all(np.isfinite(v) for v in (g, d, a)):
                    self._nonfinite_warned = True
                    print(f"WARNING: non-finite loss at step {step} (G={g} D={d} A={a}) — training has "
                          f"diverged; recover by restoring a checkpoint from BEFORE step {step} "
                          "(checkpoint pruning is now disabled so those epochs stay on disk).")
            print(f"  step {steps[-1][0]}: LossG {host[-1][0]:.4f} LossD {host[-1][1]:.4f} LossA {host[-1][2]:.4f}")
            self._metrics_buffer.clear()
        finally:
            self._flushing = False
        if self.cfg.halt_on_nonfinite and self._nonfinite_warned:
            if self.writes:
                self.writer.flush()
            raise RuntimeError("halting: non-finite loss (halt_on_nonfinite=true); restore "
                               "a pre-divergence epoch checkpoint to recover")

    # ----------------------------------------------------------- predict ----

    def _ema_model(self, state: TrainState) -> LittleGAN:
        """A model over ``state``'s storage with the EMA in G's place."""
        with torch.device("meta"):
            model = LittleGAN(self.cfg)
        model.load_state_dict(eval_params(state), assign=True)
        # the parameters stay the state's; .to moves the s2d index buffers
        return model.to(self.device).requires_grad_(False)

    def gather_eval(self) -> None:
        """With ``shard_dense``: the eval weights with the dense heads
        gathered whole, for :meth:`eval_model` until the next update (a
        collective: every rank calls it). Nothing to do otherwise."""
        if self._sync is None or not self._sync.dense:
            return
        whole = dense_whole_state(self.state, self.dp, moments=False)
        model = whole.model if whole.ema is None else self._ema_model(whole)
        self._dense_eval = (self._version, model.requires_grad_(False))

    def eval_model(self) -> LittleGAN:
        """The model inference uses: the live one, or, when the run keeps an
        EMA of G's parts, a second model over the same storage with the EMA
        in G's place. That one is built once: the step and ``restore``
        update both the parameters and the EMA in place, so it stays current
        without a copy. With ``shard_dense`` the one :meth:`gather_eval`
        made since the last update."""
        if self._sync is not None and self._sync.dense:
            if self._dense_eval is None or self._dense_eval[0] != self._version:
                raise RuntimeError("shard_dense holds a part of each dense head per rank: call gather_eval() on "
                                   "every rank after the last update, before inference")
            return self._dense_eval[1]
        if self.state.ema is None:
            return self.state.model
        if self._eval_model is None:
            self._eval_model = self._ema_model(self.state)
        return self._eval_model

    def _call(self, fn, *arrays):
        """An inference wrapper (``self._gen`` ...) on the eval weights."""
        return fn(self.eval_model(), *arrays, version=self._version)

    def predict(
        self, noise, cond, image, gen_image_save_path: Optional[str] = None,
        json_save_path: Optional[str] = None, adj_image_save_path: Optional[str] = None,
    ):
        """G on the fixture, D's scores of the real and generated images,
        the adjuster on both; writes the grids and the score JSON. Returns
        (gen image, scores, adjusted real, adjusted generated) as numpy."""
        cfg = self.cfg
        f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
        noise, cond, image = f32(noise), f32(cond), f32(image)
        start = time.time()
        gen = self._call(self._gen, noise, cond)
        gen_np = gen.cpu().numpy()
        print(f"Generate Time {time.time() - start:.4f}s")
        if gen_image_save_path:
            save_image(gen_np, gen_image_save_path)
        real_pr, real_c = self._call(self._disc, image)
        fake_pr, fake_c = self._call(self._disc, gen)
        save = d_score_stats(cond, real_pr, real_c, fake_pr, fake_c)
        if json_save_path:
            with open(json_save_path, "w") as f:
                json.dump(save, f)
        adj_real = adj_fake = None
        if cfg.train_adj:
            adj_real = self._call(self._adj, image, cond).cpu().numpy()
            adj_fake = self._call(self._adj, gen, cond).cpu().numpy()
            if adj_image_save_path:
                save_image(np.concatenate([adj_real, adj_fake]), adj_image_save_path)
        if cfg.tb_images and self._in_train:
            grid = lambda b: to_grid(inverse_rescale(np.asarray(b)).astype(np.uint8))  # noqa: E731
            self.writer.image("test/gen", grid(gen_np), self.global_step)
            if adj_real is not None:
                self.writer.image("test/adj", grid(np.concatenate([adj_real, adj_fake])), self.global_step)
        return gen_np, save, adj_real, adj_fake

    def generate(self, noise, cond) -> np.ndarray:
        """G(noise, cond) with the eval weights, f32 [-1, 1] NHWC."""
        return self._call(self._gen, np.ascontiguousarray(noise, np.float32),
                          np.ascontiguousarray(cond, np.float32)).cpu().numpy()

    def adjust(self, image, cond) -> np.ndarray:
        """The adjuster on ``image`` ([-1, 1] NHWC) and ``cond``, eval weights."""
        return self._call(self._adj, np.ascontiguousarray(image, np.float32),
                          np.ascontiguousarray(cond, np.float32)).cpu().numpy()

    def sample_u8(self, noise, cond, image) -> Tuple[np.ndarray, Dict, Optional[np.ndarray], Optional[np.ndarray]]:
        """evaluate-sample's batch in one ``inference_mode`` call, uint8
        images both in and out: G on (noise, cond), D on the real and the
        generated images and, with ``train_adj``, the adjuster on both.

        ``image``: uint8 [0, 255] rows as the pipeline yields them, or f32
        [-1, 1] (quantised and clipped on the host first). Outputs are
        quantised on the card with ``clip(round((y + 1) * 127.5), 0, 255)``,
        which rounds half to even as numpy and JAX do. Returns ``(gen_u8,
        d_score_stats dict, adj_real_u8 | None, adj_fake_u8 | None)``."""
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(inverse_rescale(arr), 0, 255).astype(np.uint8)
        out = self._call(self._sample, np.ascontiguousarray(noise, np.float32),
                         np.ascontiguousarray(cond, np.float32), np.ascontiguousarray(arr))
        with torch.inference_mode():
            images = torch.stack([out[0], *out[5:]]).cpu().numpy()  # one copy of each kind back
            scores = out[1:5]
            widths = [t.shape[1] for t in scores]
            scores = np.split(torch.cat([t.float() for t in scores], 1).cpu().numpy(), np.cumsum(widths)[:-1], 1)
        stats = d_score_stats(np.asarray(cond, np.float32), *scores)
        if self.cfg.train_adj:
            return images[0], stats, images[1], images[2]
        return images[0], stats, None, None

    # -------------------------------------------------------------- plot ----

    def _plot_specs(self):
        """(network, [(top-level label, part)]) as the JAX trainer's plot
        groups the parameter tree."""
        specs = [
            ("Encoder", [("encoder", "encoder")]),
            ("Decoder", [("decoder", "decoder")]),
            ("Discriminator", [("encoder", "encoder"), ("d_head", "d_head")]),
            ("Generator", [(k, k) for k in ("g_head", "decoder", "out_conv")]),
        ]
        if self.cfg.train_adj:
            specs.append(("Adjuster", [("encoder (shared w/ D)", "encoder"), ("adj_head (own)", "adj_head"),
                                       ("decoder (shared w/ G)", "decoder"), ("out_conv (shared w/ G)", "out_conv")]))
        return specs

    def _leaves(self, parts) -> list:
        """(path key, shape) of each parameter under ``parts``, in the JAX
        package's leaf order: sorted keys at every level, ``/``-joined."""
        by_part: Dict[str, list] = {}
        for name, p in self.state.model.named_parameters():
            top, rest = name.split(".", 1)
            by_part.setdefault(top, []).append((jax_key(rest).split("/"), tuple(p.shape)))
        leaves = [([label] + path, shape) for label, part in parts for path, shape in by_part[part]]
        return [("/".join(path), shape) for path, shape in sorted(leaves)]

    def plot(self) -> str:
        """Each network's parameters, shapes and sizes -> ``models.txt``
        (the layout of the JAX trainer's), plus a ``<network>.dot`` graph
        of its kernels. Returns the text."""
        sections = []
        for name, parts in self._plot_specs():
            leaves = self._leaves(parts)
            pad = max(0, (53 - len(name)) // 2)
            lines = ["=" * pad + f"   Model: {name}  " + "=" * pad]
            lines += [f"  {key:<48} {str(shape):<18} {int(np.prod(shape))}" for key, shape in leaves]
            lines.append(f"  total parameters: {sum(int(np.prod(shape)) for _, shape in leaves)}")
            sections.append("\n".join(lines))
            self._write_dot(name, leaves)
        text = "\n\n".join(sections) + "\n"
        with open(os.path.join(self.cfg.result_dir, "models.txt"), "w") as f:
            f.write(text)
        return text

    def _write_dot(self, name: str, leaves) -> None:
        """A graphviz chain of the network's kernels, in leaf order."""
        lines = [f'digraph "{name}" {{', "  rankdir=TB;", "  node [shape=record];"]
        prev = None
        for key, shape in leaves:
            if not key.endswith("kernel"):
                continue
            node = key.replace("/", "_").replace(" ", "_")
            lines.append(f'  {node} [label="{key.rsplit("/", 1)[0]}\\n{shape}"];')
            if prev:
                lines.append(f"  {prev} -> {node};")
            prev = node
        lines.append("}")
        with open(os.path.join(self.cfg.result_dir, f"{name}.dot"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # ------------------------------------------------------------ export ----

    def export_model_checkpoint(self) -> str:
        """The eval weights alone as ``model/ckpt-model.npz``, under the
        JAX package's bare parameter keys; returns its path."""
        from littlegan_tpu_torch.training.checkpoint import to_numpy

        flat = {jax_key(k): to_numpy(v) for k, v in eval_params(self.state).items()}
        ck = make_checkpointer(self.cfg, os.path.join(self.cfg.result_dir, "model"))
        path = ck.save_flat("model", flat)
        ck.wait()
        return path
