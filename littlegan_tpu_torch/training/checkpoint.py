"""Read the JAX package's npz checkpoints (read-only).

The JAX package writes one ``ckpt-<tag>.npz`` per checkpoint
(``littlegan_tpu/training/checkpoint.py``), tags being epoch numbers,
``interrupt`` or ``model``:

- a weights-only export (``model/ckpt-model.npz``) holds the parameter
  keys bare: ``encoder/block1/conv/kernel``, ...;
- a train checkpoint holds the whole train state: ``.params/...``, the three
  optimizer states, and ``.ema/...`` when the run kept an EMA of the
  generator's parts.

:func:`eval_params` turns either into the parameters inference serves,
with the ``.ema/*`` arrays over the live ones, as the JAX package's
``training/state.py::eval_params`` does. Nothing here creates or writes a
file. Only the npz backend is read.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np


class Checkpointer:
    """Tag-based checkpoints in one directory, read-only."""

    def __init__(self, directory: str):
        self.directory = directory

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"ckpt-{tag}.npz")

    def latest_tag(self) -> Optional[str]:
        """Numerically-latest epoch tag; a non-numeric tag ('interrupt',
        'model') wins only when its file is newer than that epoch's. None
        when the directory holds no checkpoint or does not exist."""
        if not os.path.isdir(self.directory):
            return None
        numeric: Dict[int, float] = {}
        other: Dict[str, float] = {}
        for fn in os.listdir(self.directory):
            m = re.match(r"ckpt-(.+)\.npz$", fn)
            if not m:
                continue
            mt = os.path.getmtime(os.path.join(self.directory, fn))
            if m.group(1).isdigit():
                numeric[int(m.group(1))] = mt
            else:
                other[m.group(1)] = mt
        if not numeric:
            return max(other, key=lambda t: other[t]) if other else None
        best = max(numeric)
        newer = [t for t, mt in other.items() if mt > numeric[best]]
        if newer:
            return max(newer, key=lambda t: other[t])
        return str(best)

    def tag_fingerprint(self, tag: str) -> Optional[float]:
        """Change token for ``tag`` (its file's mtime): an overwritten
        same-tag checkpoint reads as new."""
        try:
            return os.path.getmtime(self._path(str(tag)))
        except OSError:
            return None

    def restore_flat(self, tag: str) -> Dict[str, np.ndarray]:
        """Every array of the checkpoint, by its path key."""
        with np.load(self._path(tag)) as z:
            return {k: z[k] for k in z.files}


def make_checkpointer(cfg, directory: str) -> Checkpointer:
    if getattr(cfg, "extra", {}).get("checkpoint_backend") == "orbax":
        raise NotImplementedError("the port reads npz checkpoints only, not orbax ones")
    return Checkpointer(directory)


def eval_params(flat: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], bool]:
    """(parameters to serve, whether EMA arrays were overlaid) from a
    checkpoint's arrays: bare keys as they are; a train state's
    ``.params/*`` with its ``.ema/*`` on top."""
    params = {k[len(".params/"):]: v for k, v in flat.items() if k.startswith(".params/")}
    if not params:
        return dict(flat), False
    ema = {k[len(".ema/"):]: v for k, v in flat.items() if k.startswith(".ema/")}
    params.update(ema)
    return params, bool(ema)
