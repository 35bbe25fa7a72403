"""Where the port's entry points run."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else this process's card: ``cuda:LOCAL_RANK``
    under ``torchrun`` (one process per card), else the current CUDA
    device; raises when no device is given and there is no CUDA device
    (never a silent CPU run)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: littlegan_tpu_torch runs on the GPU; pass device='cpu' "
            "to run on the CPU instead"
        )
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.device("cuda", torch.cuda.current_device())
    if int(local) >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} visible CUDA device(s): "
                           "start at most one process per card")
    return torch.device("cuda", int(local))
