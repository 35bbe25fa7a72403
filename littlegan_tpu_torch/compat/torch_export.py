"""``torch.export`` artifacts of the inference entry points.

The port's counterpart of littlegan_tpu/compat/stablehlo.py: where the JAX
package serializes its jitted forwards to StableHLO with ``jax.export``, the
port serializes its forwards with ``torch.export`` to ``.pt2`` files that
``torch.export.load(path).module()`` runs with no model code (and that
AOTInductor-class runtimes consume). The same three entry points, in
float32 and traced on the plain ops (``ops/cuda/_build.py::plain_versions``:
a trace cannot follow a ctypes launch, and the JAX export runs without its
Pallas kernels), the EMA generator weights when the checkpoint carries
them (``training/state.py::eval_params``):

- ``generate(noise[b,noise_dim], cond[b,cond_dim]) -> image [b,H,W,3]``
- ``adjust(image[b,H,W,3], cond[b,cond_dim]) -> image [b,H,W,3]``
- ``discriminate(image[b,H,W,3]) -> {'pr': [b,1], 'cond': [b,cond_dim]}``

The batch is a symbolic dimension (1 to ``MAX_BATCH``), so one file serves
every batch size. Artifacts under ``<out_dir>/``:

- ``<name>.pt2`` (``torch.export.save``), weights inside;
- ``manifest.json``: input/output shapes and dtypes, ``image_dim``, bytes
  per file, the device the program was exported on (its constants live
  there) and the torch version.

    python -m littlegan_tpu_torch.compat.torch_export <exp> [-e ENV] [--out DIR] \\
        [--only generate,adjust,discriminate] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models.littlegan import LittleGAN
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.utils.device import resolve_device

ENTRY_POINTS = ("generate", "adjust", "discriminate")
MAX_BATCH = 4096


class Generate(nn.Module):
    def __init__(self, model: LittleGAN):
        super().__init__()
        self.model = model

    def forward(self, noise: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return self.model.generator(noise, cond).float()


class Adjust(nn.Module):
    def __init__(self, model: LittleGAN):
        super().__init__()
        self.model = model

    def forward(self, image: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return self.model.adjuster(image, cond).float()


class Discriminate(nn.Module):
    def __init__(self, model: LittleGAN):
        super().__init__()
        self.model = model

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        pr, cond = self.model.discriminator(image)
        return {"pr": pr.float(), "cond": cond.float()}


def export_model(cfg: Config, params: Mapping[str, Any], device=None) -> LittleGAN:
    """The model the exports trace: ``cfg`` in float32, holding ``params``
    (``name -> tensor``, as ``training/state.py::eval_params`` gives them)
    in float32 on ``device``."""
    model = LittleGAN(cfg.replace(compute_dtype="float32"))
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in params.items()})
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def _aval(t: torch.Tensor) -> str:
    """``float32[b,16,16,3]``: the JAX manifest's notation, b the batch."""
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(['b'] + [str(d) for d in t.shape[1:]])}]"


def export_torch(
    cfg: Config,
    params: Mapping[str, Any],
    out_dir: str,
    include: tuple = ENTRY_POINTS,
    device=None,
) -> str:
    """Write a ``.pt2`` per entry point of ``include`` and ``manifest.json``
    to ``out_dir``; returns ``out_dir``. ``params``: ``name -> tensor`` (pass
    ``eval_params(state)`` for the EMA weights). The programs are traced on
    ``device`` (the card unless ``device="cpu"``), where their weights stay."""
    unknown = set(include) - set(ENTRY_POINTS)
    if unknown or not include:
        raise ValueError(f"include must be a non-empty subset of {ENTRY_POINTS}, got {include!r}")
    model = export_model(cfg, params, device)
    dev = next(model.parameters()).device
    h = w = cfg.image_dim
    c = cfg.image_channel
    ex = 2  # the example batch; the exported batch is symbolic
    noise = torch.zeros(ex, cfg.noise_dim, device=dev)
    cond = torch.zeros(ex, cfg.cond_dim, device=dev)
    image = torch.zeros(ex, h, w, c, device=dev)
    b = torch.export.Dim("b", min=1, max=MAX_BATCH)
    entries = {
        "generate": (Generate(model), (noise, cond), {"noise": {0: b}, "cond": {0: b}}),
        "adjust": (Adjust(model), (image, cond), {"image": {0: b}, "cond": {0: b}}),
        "discriminate": (Discriminate(model), (image,), {"image": {0: b}}),
    }

    os.makedirs(out_dir, exist_ok=True)
    manifest: Dict[str, Any] = {"entry_points": {}, "image_dim": cfg.image_dim, "device": str(dev),
                                "torch_version": torch.__version__}
    for name in include:
        module, args, dynamic = entries[name]
        with _build.plain_versions():
            program = torch.export.export(module, args, dynamic_shapes=dynamic)
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(program, path)
        with torch.no_grad():
            outs = torch.utils._pytree.tree_leaves(module(*args))
        manifest["entry_points"][name] = {
            "in_avals": [_aval(a) for a in args],
            "out_avals": [_aval(o) for o in outs],
            "device": str(dev),
            "pt2_bytes": os.path.getsize(path),
        }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def export_experiment(cfg: Config, out_dir: Optional[str] = None, device=None, **kw) -> str:
    """Export the experiment's latest checkpoint (EMA weights when present)
    to ``result/<exp>/model/torch_export`` by default."""
    from littlegan_tpu_torch.training.checkpoint import make_checkpointer
    from littlegan_tpu_torch.training.state import create_train_state, eval_params

    dev = resolve_device(device)
    template = create_train_state(cfg, dev)
    state, _ = make_checkpointer(cfg, os.path.join(cfg.result_dir, "checkpoint")).restore_latest(template)
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {cfg.result_dir}/checkpoint — train first")
    if out_dir is None:
        out_dir = os.path.join(cfg.result_dir, "model", "torch_export")
    return export_torch(cfg, eval_params(state), out_dir, device=dev, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m littlegan_tpu_torch.compat.torch_export",
                                 description="Export an experiment's latest checkpoint with torch.export.")
    ap.add_argument("exp_name")
    ap.add_argument("-e", "--env", default="sample")
    ap.add_argument("--out", default=None, help="output dir (default result/<exp>/model/torch_export)")
    ap.add_argument("--only", default=",".join(ENTRY_POINTS), help="comma-separated subset of entry points")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from littlegan_tpu_torch.config import load_config

    cfg = load_config(env=args.env, overrides={"exp_name": args.exp_name, "mode": "export-model"})
    include = tuple(s.strip() for s in args.only.split(",") if s.strip())
    out = export_experiment(cfg, out_dir=args.out, device=args.device, include=include)
    print(f"torch.export artifacts written to {out} (entry points: {', '.join(include)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
