"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the current CUDA device; raises when no
    device is given and there is no CUDA device (never a silent CPU run)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: littlegan_tpu_torch runs on the GPU; pass device='cpu' "
            "to run on the CPU instead"
        )
    return torch.device("cuda", torch.cuda.current_device())
