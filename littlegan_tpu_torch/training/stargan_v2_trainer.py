"""The host loop that trains StarGAN v2 (``Config.model = "stargan_v2"``).

- result tree and provenance (``config.json``, ``code.tar``), as
  :class:`~littlegan_tpu_torch.training.trainer.Trainer` writes them;
- the whole domain-folder set (``data/domains.py``) decoded once and held
  on the card as a uint8 store with its labels (``device_data``, which this
  model requires);
- epochs of ``len(dataset) // batch_size`` iterations, ``steps_per_dispatch``
  = K per call of ``training/stargan_v2.py::make_stargan_scan_step`` (one
  CUDA graph replay on the card; a trailing remainder group runs its own
  graph). Each iteration's ids come from the epoch's
  :class:`~littlegan_tpu_torch.data.domains.BalancedSampler` stream
  (numpy, seeded from ``(seed, epoch)``), its draws from a generator on the
  card seeded from ``(seed, iteration)``, so a run resumed at an epoch
  boundary draws what an unbroken one would;
- the 14 loss terms to TensorBoard (``loss/<phase>.<term>``, flushed every
  16 calls in one copy from the card, the last printed); every
  ``freq_gen`` iterations a grid (group-snapped) of the fixture's source
  images beside their translations into every domain with the EMA weights,
  ``train/gen/<epoch>-<iteration>.jpg``;
- a checkpoint per epoch (``training/checkpoint.py``, npz: the state's
  parameters, four Adams and EMA), restored at start with ``restore``.

It runs on the card unless ``device="cpu"`` is given. Refused: what
``models/stargan_v2.py::check_supported`` refuses, and a set-up without
``device_data``. No mid-epoch interrupt checkpoint: a run resumes at its
last epoch.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.data.domains import BalancedSampler
from littlegan_tpu_torch.models.stargan_v2 import check_supported
from littlegan_tpu_torch.training.checkpoint import Checkpointer
from littlegan_tpu_torch.training.stargan_v2 import (
    LOSS_KEYS, draw_iteration, make_stargan_scan_step, stack_draws, translate,
)
from littlegan_tpu_torch.training.state import StarGANState, create_stargan_state
from littlegan_tpu_torch.utils.device import resolve_device
from littlegan_tpu_torch.utils.image import save_image
from littlegan_tpu_torch.utils.provenance import init_result_dirs, snapshot_run
from littlegan_tpu_torch.utils.tensorboard import SummaryWriter

FLUSH_EVERY = 16
GRID_ROWS = 8


class StarGANTrainer:
    def __init__(self, cfg: Config, dataset, device=None):
        check_supported(cfg)
        if not cfg.device_data:
            raise ValueError("model stargan_v2 trains from the card-resident store: set device_data true")
        self.cfg, self.dataset = cfg, dataset
        self.device = resolve_device(device)
        init_result_dirs(cfg)
        snapshot_run(cfg)
        self.state: StarGANState = create_stargan_state(cfg, self.device)
        self.checkpointer = Checkpointer(os.path.join(cfg.result_dir, "checkpoint"))
        status: Dict = {}
        if cfg.restore:
            restored, status = self.checkpointer.restore_latest(self.state)
            if restored is not None:
                print("Restored checkpoint", self.checkpointer.latest_tag())
        self.global_epoch = int(status.get("epoch", 1))
        self.iteration = int(status.get("step", 0))
        self._steps: Dict[int, object] = {}  # K -> K-iteration step (one CUDA graph each)
        self._generator = torch.Generator(device=self.device)
        self._writer = SummaryWriter(os.path.join(cfg.result_dir, "log"))
        self._buffer: List = []  # (first iteration, (K, 14) losses on the card) per call

    def _step(self, k: int):
        if k not in self._steps:
            self._steps[k] = make_stargan_scan_step(self.cfg, self.state, k)
        return self._steps[k]

    def draws(self, it: int):
        self._generator.manual_seed(self.cfg.seed * 1_000_003 + it)
        return draw_iteration(self._generator, self.cfg, self.device)

    def train(self) -> None:
        cfg = self.cfg
        images_np, labels_np = self.dataset.load()
        print(f"device_data: uploading {images_np.nbytes / 1e9:.2f} GB of {len(labels_np)} images in "
              f"{cfg.num_domains} domains to {self.device}")
        images, labels = torch.from_numpy(images_np).to(self.device), torch.from_numpy(labels_np).to(self.device)
        sampler = BalancedSampler(labels_np, cfg.num_domains)
        per_epoch = len(labels_np) // cfg.batch_size
        if per_epoch == 0:
            raise ValueError(f"the set has {len(labels_np)} images, fewer than batch_size {cfg.batch_size}")
        fixture = sampler.draw(np.random.default_rng((cfg.seed, 0)), cfg.batch_size)[:min(GRID_ROWS, cfg.batch_size)]
        fixture_z = torch.randn((len(fixture), cfg.latent_dim), generator=torch.Generator().manual_seed(cfg.seed))
        k = max(1, cfg.steps_per_dispatch)
        for epoch in range(self.global_epoch, cfg.epoch + 1):
            print(f"Experiment: {cfg.exp_name} Epoch: {epoch} starting...")
            start, done = time.time(), 0
            rng = np.random.default_rng((cfg.seed, epoch))
            while done < per_epoch:
                kk = min(k, per_epoch - done)
                ids = np.stack([sampler.draw(rng, cfg.batch_size) for _ in range(kk)])
                draws = stack_draws([self.draws(self.iteration + i) for i in range(kk)])
                losses = self._step(kk)(self.state, images, labels, ids, draws, self.iteration)
                self._buffer.append((self.iteration, losses))
                prev, self.iteration, done = self.iteration, self.iteration + kk, done + kk
                if len(self._buffer) >= FLUSH_EVERY:
                    self._flush()
                if cfg.freq_gen > 0 and self.iteration // cfg.freq_gen > prev // cfg.freq_gen:
                    self._save_grid(images[torch.as_tensor(fixture, device=self.device)], fixture_z, epoch)
            self._flush()
            elapsed = time.time() - start
            print(f"Time usage: {elapsed:.1f}s  ({2 * cfg.batch_size * done / max(elapsed, 1e-9):.1f} images/s)")
            if cfg.ckpt_every <= 1 or epoch % cfg.ckpt_every == 0 or epoch == cfg.epoch:
                self.checkpointer.save(str(epoch), self.state, {"epoch": epoch + 1, "step": self.iteration})
        self._writer.flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        host = torch.cat([losses for _, losses in self._buffer]).cpu().numpy()
        its = [it0 + i for it0, losses in self._buffer for i in range(losses.shape[0])]
        for it, row in zip(its, host):
            self._writer.scalars([(f"loss/{k}", float(v)) for k, v in zip(LOSS_KEYS, row)], it + 1)
        if not np.isfinite(host).all():
            print(f"WARNING: non-finite loss by iteration {its[-1] + 1}: training has diverged")
        last = dict(zip(LOSS_KEYS, host[-1]))
        print(f"  iteration {its[-1] + 1}: " + " ".join(f"{k} {last[k]:.4f}" for k in
                                                         ("d_latent.real", "d_latent.reg", "g_latent.adv",
                                                          "g_latent.cyc")))
        self._buffer.clear()

    def _save_grid(self, source_u8: torch.Tensor, z: torch.Tensor, epoch: int) -> None:
        """Each fixture source, then its translation into every domain."""
        x = source_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        out = translate(self.state.model, self.cfg, x, z.to(self.device), self.state.ema)
        grid = torch.cat([x[:, None], out], 1).clamp(-1, 1).permute(0, 1, 3, 4, 2)
        grid = grid.reshape(-1, *grid.shape[2:]).cpu().numpy()
        path = os.path.join(self.cfg.result_dir, "train", "gen", f"{epoch}-{self.iteration}.jpg")
        save_image(grid, path, (x.shape[0], self.cfg.num_domains + 1))
