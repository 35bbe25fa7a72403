"""The host loop that trains StyleGAN2 (``Config.model = "stylegan2"``).

- result tree and provenance (``config.json``, ``code.tar``), as
  :class:`~littlegan_tpu_torch.training.trainer.Trainer` writes them;
- the whole image set (``data/image_folder.py``) decoded once and held on
  the card as a uint8 store (``device_data``, which this model requires);
- epochs of ``len(dataset) // batch_size`` iterations, numbered on across
  epochs (the lazy phases follow the iteration's number), ``steps_per_dispatch``
  = K per call of ``training/stylegan2.py::make_stylegan2_scan_step`` (one
  CUDA graph replay per phase pattern on the card). A call's draws come
  from a generator on the card seeded from ``(seed, first iteration)``, so
  a run resumed at an epoch boundary draws what an unbroken one would;
- the 6 terms to TensorBoard (``loss/<term>``, flushed every 16 calls in
  one copy from the card, the last printed); every ``freq_gen`` iterations
  a grid of the EMA generator's images of fixed z,
  ``train/gen/<epoch>-<iteration>.jpg``;
- a checkpoint per epoch (``training/checkpoint.py``, npz: the state's
  parameters, both Adams and the EMA, with ``pl_mean`` and ``w_avg`` under
  ``.pl_mean`` and ``.buffers/G/mapping/w_avg``), restored at start with
  ``restore``.

It runs on the card unless ``device="cpu"`` is given. Refused: what
``models/stylegan2.py::check_supported`` refuses, and a set-up without
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
from littlegan_tpu_torch.models.stylegan2 import check_supported, noise_sizes
from littlegan_tpu_torch.training.checkpoint import Checkpointer, flatten_state
from littlegan_tpu_torch.training.state import StyleGAN2State, create_stylegan2_state
from littlegan_tpu_torch.training.stylegan2 import (
    LOSS_KEYS, draw_iteration, generate, make_stylegan2_scan_step, stack_draws,
)
from littlegan_tpu_torch.utils.device import resolve_device
from littlegan_tpu_torch.utils.image import save_image
from littlegan_tpu_torch.utils.provenance import init_result_dirs, snapshot_run
from littlegan_tpu_torch.utils.tensorboard import SummaryWriter

FLUSH_EVERY = 16
GRID = 16
EXTRA = (".pl_mean", ".buffers/G/mapping/w_avg")


class StyleGAN2Trainer:
    def __init__(self, cfg: Config, dataset, device=None):
        check_supported(cfg)
        if not cfg.device_data:
            raise ValueError("model stylegan2 trains from the card-resident store: set device_data true")
        self.cfg, self.dataset = cfg, dataset
        self.device = resolve_device(device)
        init_result_dirs(cfg)
        snapshot_run(cfg)
        self.state: StyleGAN2State = create_stylegan2_state(cfg, self.device)
        self.checkpointer = Checkpointer(os.path.join(cfg.result_dir, "checkpoint"))
        status: Dict = {}
        if cfg.restore:
            restored, status = self.checkpointer.restore_latest(self.state)
            if restored is not None:
                flat = self.checkpointer.restore_flat(self.checkpointer.latest_tag())
                with torch.no_grad():
                    for key, t in zip(EXTRA, self._extra()):
                        t.copy_(torch.as_tensor(flat[key]))
                print("Restored checkpoint", self.checkpointer.latest_tag())
        self.global_epoch = int(status.get("epoch", 1))
        self.iteration = int(status.get("step", 0))
        self._steps: Dict[int, object] = {}  # K -> K-iteration step
        self._generator = torch.Generator(device=self.device)
        self._writer = SummaryWriter(os.path.join(cfg.result_dir, "log"))
        self._buffer: List = []  # (first iteration, (K, 6) terms on the card) per call

    def _extra(self):
        return self.state.pl_mean, self.state.model.G.mapping.w_avg

    def _step(self, k: int):
        if k not in self._steps:
            self._steps[k] = make_stylegan2_scan_step(self.cfg, self.state, k)
        return self._steps[k]

    def draws(self, it0: int, k: int, n_store: int):
        self._generator.manual_seed(self.cfg.seed * 1_000_003 + it0)
        return stack_draws([draw_iteration(self._generator, self.cfg, self.device, it, n_store)
                            for it in range(it0, it0 + k)])

    def train(self) -> None:
        cfg = self.cfg
        images_np = self.dataset.load()
        print(f"device_data: uploading {images_np.nbytes / 1e9:.2f} GB of {len(images_np)} images to {self.device}")
        images = torch.from_numpy(images_np).to(self.device)
        per_epoch = len(images_np) // cfg.batch_size
        if per_epoch == 0:
            raise ValueError(f"the set has {len(images_np)} images, fewer than batch_size {cfg.batch_size}")
        gen = torch.Generator().manual_seed(cfg.seed)
        fixture_z = torch.randn((GRID, cfg.z_dim), generator=gen).to(self.device)
        fixture_noise = torch.randn((GRID, sum(r * r for r in noise_sizes(cfg.image_dim))), generator=gen).to(
            self.device)
        k = max(1, cfg.steps_per_dispatch)
        for epoch in range(self.global_epoch, cfg.epoch + 1):
            print(f"Experiment: {cfg.exp_name} Epoch: {epoch} starting...")
            start, done = time.time(), 0
            while done < per_epoch:
                kk = min(k, per_epoch - done)
                terms = self._step(kk)(self.state, images, self.draws(self.iteration, kk, len(images_np)),
                                       self.iteration)
                self._buffer.append((self.iteration, terms))
                prev, self.iteration, done = self.iteration, self.iteration + kk, done + kk
                if len(self._buffer) >= FLUSH_EVERY:
                    self._flush()
                if cfg.freq_gen > 0 and self.iteration // cfg.freq_gen > prev // cfg.freq_gen:
                    self._save_grid(fixture_z, fixture_noise, epoch)
            self._flush()
            elapsed = time.time() - start
            print(f"Time usage: {elapsed:.1f}s  ({2 * cfg.batch_size * done / max(elapsed, 1e-9):.1f} images/s)")
            if cfg.ckpt_every <= 1 or epoch % cfg.ckpt_every == 0 or epoch == cfg.epoch:
                flat = flatten_state(self.state)
                flat.update({key: t.detach().cpu().numpy() for key, t in zip(EXTRA, self._extra())})
                self.checkpointer.save_flat(str(epoch), flat, {"epoch": epoch + 1, "step": self.iteration})
        self._writer.flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        host = torch.cat([terms for _, terms in self._buffer]).cpu().numpy()
        its = [it0 + i for it0, terms in self._buffer for i in range(terms.shape[0])]
        for it, row in zip(its, host):
            self._writer.scalars([(f"loss/{k}", float(v)) for k, v in zip(LOSS_KEYS, row)], it + 1)
        if not np.isfinite(host).all():
            print(f"WARNING: non-finite loss by iteration {its[-1] + 1}: training has diverged")
        last = dict(zip(LOSS_KEYS, host[-1]))
        print(f"  iteration {its[-1] + 1}: " + " ".join(f"{k} {last[k]:.4f}" for k in LOSS_KEYS))
        self._buffer.clear()

    def _save_grid(self, z: torch.Tensor, noise: torch.Tensor, epoch: int) -> None:
        img = generate(self.state, self.cfg, z, noise.to(getattr(torch, self.cfg.compute_dtype)))
        grid = img.clamp(-1, 1).permute(0, 2, 3, 1).cpu().numpy()
        path = os.path.join(self.cfg.result_dir, "train", "gen", f"{epoch}-{self.iteration}.jpg")
        side = int(np.ceil(np.sqrt(len(grid))))
        save_image(grid, path, (side, side))
