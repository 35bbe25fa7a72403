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
group until n steps are covered.

It runs on the card unless ``device="cpu"`` is given; without a card and
without that argument it raises. Refused: what ``step.check_supported``
refuses (the gradient penalty with a kernel flag, ``ValueError``), and,
with ``NotImplementedError``, meshes and sharded state (ROADMAP A13).
"""

from __future__ import annotations

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
from littlegan_tpu_torch.training.checkpoint import make_checkpointer
from littlegan_tpu_torch.training.state import TrainState, create_train_state, eval_params
from littlegan_tpu_torch.training.step import (
    LOSS_KEYS, check_supported, draw_step, make_accum_train_step, make_gather_train_step,
    make_scan_accum_train_step, make_scan_train_step, make_train_step, stack_draws,
)
from littlegan_tpu_torch.utils.device import resolve_device
from littlegan_tpu_torch.utils.image import (
    data_rescale, ensure_pm1, inverse_rescale, save_image, soft, to_grid,
)
from littlegan_tpu_torch.utils.provenance import init_result_dirs, snapshot_run
from littlegan_tpu_torch.utils.tensorboard import SummaryWriter

FLUSH_EVERY = 16  # calls whose losses stay on the card before one copy to the host


def check_trainer_supported(cfg: Config) -> None:
    """Refuse what the step refuses, and the multi-device options the port
    does not have yet."""
    check_supported(cfg)
    for on, what in (
        (cfg.mesh_shape is not None or tuple(cfg.mesh_axes) != ("data",), "a device mesh"),
        (cfg.shard_opt_state or cfg.shard_dense, "sharded train state"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported to littlegan_tpu_torch yet (ROADMAP A13)")


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


class Trainer:
    def __init__(self, cfg: Config, dataset=None, device=None):
        check_trainer_supported(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        init_result_dirs(cfg)
        snapshot_run(cfg)
        self.state: TrainState = create_train_state(cfg, self.device)
        self.global_epoch = 1
        self.global_step = 0
        self._resume_batch = 0  # mid-epoch resume point (interrupt checkpoints only)
        self._cur_batch_no = 0  # batches completed in the current epoch
        self.checkpointer = make_checkpointer(cfg, os.path.join(cfg.result_dir, "checkpoint"))
        if cfg.restore:
            restored, status = self.checkpointer.restore_latest(self.state)
            if restored is not None:
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
        self._init_fixture()
        if cfg.grad_accum > 1 and getattr(dataset, "batches", None) is not None \
                and dataset.batches < 2 * cfg.grad_accum:
            print(f"WARNING: dataset has {dataset.batches} batches but one accumulation group consumes "
                  f"{2 * cfg.grad_accum}; every epoch would apply ZERO updates. Lower grad_accum or grow "
                  "the dataset.")
        self._train_step = make_train_step(cfg, self.state)
        self._accum_step = make_accum_train_step(cfg, self.state)
        self._gather_step = make_gather_train_step(cfg, self.state)
        self._generator = torch.Generator(device=self.device)
        self._prefetch = Prefetcher(self.device)
        self._profile: Optional[ProfileWindow] = None  # the run's window (profile_steps), made in train()

    # ---------------------------------------------------------- fixture ----

    def _init_fixture(self) -> None:
        """The pinned (noise, cond, image) eval triplet, reused from
        ``test_data_<env>.npz`` when ``cfg.reuse`` and the file exists,
        else made anew and written there atomically."""
        cfg = self.cfg
        npz = os.path.join(cfg.test_data_dir, f"test_data_{cfg.env}.npz")
        reuse = cfg.reuse and os.path.isfile(npz)
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
        self.test_noise, self.test_cond, self.test_image = noise, cond, image
        if not reuse:
            os.makedirs(cfg.test_data_dir, exist_ok=True)
            tmp = npz + ".tmp"
            with open(tmp, "wb") as f:
                np.savez_compressed(f, n=noise, c=cond, i=image)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, npz)

    # ------------------------------------------------------------- train ----

    def draws(self, global_step: int, micro: Optional[int] = None):
        """The draws of step ``global_step`` (or of its micro-step ``micro``)."""
        self._generator.manual_seed(step_seed(self.cfg.seed, global_step, micro))
        return draw_step(self._generator, self.cfg, self.cfg.batch_size, self.device)

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
        sequence."""
        if self._device_store is None:
            cache = getattr(self.dataset, "_cache", None)  # a decode cache is dead weight here
            if cache is not None:
                self.dataset._cache = None
            try:
                images, conds = zip(*self.dataset.epoch_iterator(0, shuffle=False))
            finally:
                if cache is not None:
                    self.dataset._cache = cache
            b = self.cfg.batch_size
            imgs, cs = np.concatenate(images), np.concatenate(conds).astype(np.float32)
            n = imgs.shape[0] // b
            imgs = imgs[: n * b].reshape(n, b, *imgs.shape[1:])
            cs = cs[: n * b].reshape(n, b, -1)
            print(f"device_data: uploading {imgs.nbytes / 1e9:.2f} GB {imgs.dtype} dataset "
                  f"({n} batches) to {self.device}")
            self._device_store = (torch.from_numpy(imgs).to(self.device), torch.from_numpy(cs).to(self.device))
        return self._device_store

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
            self._scan_steps[k] = make(self.cfg, self.state, k)
        return self._scan_steps[k]

    def _uses_scan(self) -> bool:
        cfg = self.cfg
        return cfg.device_data and (cfg.steps_per_dispatch > 1 or cfg.grad_accum > 1)

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

    def _save_interrupt(self):
        self._flush_buffered()
        self.writer.flush()
        self.checkpointer.save(
            "interrupt", self.state,
            {"epoch": self.global_epoch, "step": self.global_step, "batch": self._cur_batch_no},
        )
        print("\nCheckpoint has been saved (interrupt)")
        sys.exit(1)

    def _save_epoch_checkpoint(self, epoch: int) -> None:
        cfg = self.cfg
        if cfg.ckpt_every > 1 and epoch % cfg.ckpt_every != 0 and epoch != cfg.epoch:
            return
        self.checkpointer.save(str(epoch), self.state, {"epoch": epoch + 1, "step": self.global_step})
        if cfg.keep_checkpoints > 0:
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
        self._profile = ProfileWindow(cfg, self.device) if cfg.profile_steps > 0 else None
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
                if self._interrupt_requested:
                    self._save_interrupt()
                if epoch_callback is not None:
                    epoch_callback(epoch)
        finally:
            self._in_train = False
            if main:
                signal.signal(signal.SIGINT, prev_handler)
            if self._writer is not None:
                self._writer.flush()

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
                _accum_groups(_pairwise(self.dataset.epoch_iterator(epoch, start_batch=2 * m * resume_b)), m))

            def run(b1, b2, draws, batch_no):
                return self._accum_step(self.state, b1, b2, draws, batch_no)
        else:
            updates = self._prefetch(_pairwise(self.dataset.epoch_iterator(epoch, start_batch=2 * resume_b)))

            def run(b1, b2, draws, batch_no):
                return self._train_step(self.state, b1, b2, draws, batch_no)

        batch_no = resume_b
        self._cur_batch_no = batch_no
        images_done = 0
        prof = self._profile if first else None
        for b1, b2 in updates:
            batch_no += 1
            self._cur_batch_no = batch_no
            self.global_step += 1
            if prof is not None:  # steps [10, 10 + n) of the first epoch
                if batch_no == 10 and not prof.started:
                    prof.start()
                elif prof.active and batch_no == 10 + prof.steps:
                    prof.stop()
            out = run(b1, b2, self.update_draws(self.global_step), batch_no)
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
        if len(self._metrics_buffer) >= FLUSH_EVERY:
            self._flush_buffered()
        if cfg.freq_gen > 0 and batch_no // cfg.freq_gen > prev_batch // cfg.freq_gen:
            self._save_train_images(out, epoch, batch_no)
        if cfg.freq_test > 0 and batch_no // cfg.freq_test > prev_batch // cfg.freq_test:
            name = f"{epoch}-{batch_no}"
            self.predict(
                self.test_noise, self.test_cond, self.test_image,
                os.path.join(cfg.result_dir, "test", "gen", f"{name}.jpg"),
                os.path.join(cfg.result_dir, "test", "disc", f"{name}.json"),
                os.path.join(cfg.result_dir, "test", "adj", f"{name}.jpg"),
            )
        if self._interrupt_requested:
            self._save_interrupt()

    def _save_train_images(self, out, epoch: int, batch_no: int) -> None:
        base = os.path.join(self.cfg.result_dir, "train")
        save_image(out.fake_image.float().cpu().numpy(), os.path.join(base, "gen", f"{epoch}-{batch_no}.jpg"))
        if self.cfg.train_adj:
            save_image(out.adj_image.float().cpu().numpy(), os.path.join(base, "adj", f"{epoch}-{batch_no}.jpg"))

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
            self.writer.flush()
            raise RuntimeError("halting: non-finite loss (halt_on_nonfinite=true); restore "
                               "a pre-divergence epoch checkpoint to recover")

    # ----------------------------------------------------------- predict ----

    def eval_model(self) -> LittleGAN:
        """The model inference uses: the live one, or, when the run keeps an
        EMA of G's parts, a second model over the same storage with the EMA
        in G's place. That one is built once: the step and ``restore``
        update both the parameters and the EMA in place, so it stays current
        without a copy."""
        if self.state.ema is None:
            return self.state.model
        if self._eval_model is None:
            with torch.device("meta"):
                model = LittleGAN(self.cfg)
            model.load_state_dict(eval_params(self.state), assign=True)
            self._eval_model = model.requires_grad_(False)
        return self._eval_model

    def _tensor(self, a, dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

    def predict(
        self, noise, cond, image, gen_image_save_path: Optional[str] = None,
        json_save_path: Optional[str] = None, adj_image_save_path: Optional[str] = None,
    ):
        """G on the fixture, D's scores of the real and generated images,
        the adjuster on both; writes the grids and the score JSON. Returns
        (gen image, scores, adjusted real, adjusted generated) as numpy."""
        cfg = self.cfg
        model = self.eval_model()
        t = self._tensor
        with torch.inference_mode():
            start = time.time()
            gen = model.generator(t(noise), t(cond)).float()
            gen_np = gen.cpu().numpy()
            print(f"Generate Time {time.time() - start:.4f}s")
            if gen_image_save_path:
                save_image(gen_np, gen_image_save_path)
            real_pr, real_c = model.discriminator(t(image))
            fake_pr, fake_c = model.discriminator(gen)
            save = d_score_stats(cond, real_pr, real_c, fake_pr, fake_c)
            if json_save_path:
                with open(json_save_path, "w") as f:
                    json.dump(save, f)
            adj_real = adj_fake = None
            if cfg.train_adj:
                adj_real = model.adjuster(t(image), t(cond)).float().cpu().numpy()
                adj_fake = model.adjuster(gen, t(cond)).float().cpu().numpy()
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
        with torch.inference_mode():
            return self.eval_model().generator(self._tensor(noise), self._tensor(cond)).float().cpu().numpy()

    def adjust(self, image, cond) -> np.ndarray:
        """The adjuster on ``image`` ([-1, 1] NHWC) and ``cond``, eval weights."""
        with torch.inference_mode():
            return self.eval_model().adjuster(self._tensor(image), self._tensor(cond)).float().cpu().numpy()

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
        q = lambda y: torch.clamp(torch.round((y.float() + 1.0) * 127.5), 0, 255).to(torch.uint8)  # noqa: E731
        model = self.eval_model()
        with torch.inference_mode():
            c = self._tensor(cond)
            img = data_rescale(self._tensor(arr, np.uint8).float())
            gen = model.generator(self._tensor(noise), c).float()
            scores = [*model.discriminator(img), *model.discriminator(gen)]
            images = [q(gen)]
            if self.cfg.train_adj:
                images += [q(model.adjuster(img, c)), q(model.adjuster(gen, c))]
            images = torch.stack(images).cpu().numpy()  # one copy of each kind back
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
        return make_checkpointer(self.cfg, os.path.join(self.cfg.result_dir, "model")).save_flat("model", flat)
