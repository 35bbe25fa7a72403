"""npz checkpoints in the JAX package's format, read and written.

The JAX package writes one ``ckpt-<tag>.npz`` per checkpoint
(``littlegan_tpu/training/checkpoint.py``), tags being epoch numbers,
``interrupt`` or ``model``, and a ``status.json`` beside them:

- a weights-only export (``model/ckpt-model.npz``) holds the parameter
  keys bare: ``encoder/block1/conv/kernel``, ...;
- a train checkpoint holds the whole train state under the flat keys of its
  pytree: ``.params/<key>``, ``.opt_g/.count/<key>`` (int32 scalars),
  ``.opt_g/.mu/<key>`` and ``.opt_g/.nu/<key>`` (in the moment dtype; a
  bfloat16 array is stored as raw 2-byte void, as numpy saves JAX's), the
  same for ``.opt_d`` and ``.opt_a``, and ``.ema/<key>`` when the run keeps
  an EMA of the generator's parts.

:class:`Checkpointer` writes a port :class:`TrainState` under those keys and
layouts, so a checkpoint of either package restores in the other. A save
writes a temporary file in the same directory, fsyncs it and renames it
over the tag; ``status.json`` is written the same way.
:func:`eval_params` turns either kind into the parameters inference serves,
with the ``.ema/*`` arrays over the live ones. Only the npz backend exists.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from littlegan_tpu_torch.compat.jax_params import jax_key


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host array as the JAX package stores it: bfloat16 as 2-byte void."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`to_numpy`, cast to ``dtype``."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(dtype)
    return torch.from_numpy(np.array(arr)).to(dtype)


def _write_status(directory: str, status: Dict[str, Any]) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".status.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(status, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, "status.json"))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def flatten_state(state) -> Dict[str, np.ndarray]:
    """A port TrainState under the JAX package's flat keys."""
    flat = {f".params/{jax_key(n)}": to_numpy(p) for n, p in state.model.named_parameters()}
    for name in ("opt_g", "opt_d", "opt_a"):
        opt = getattr(state, name)
        for k in opt.mu:
            key = jax_key(k)
            flat[f".{name}/.count/{key}"] = np.asarray(opt.count[k], np.int32)
            flat[f".{name}/.mu/{key}"] = to_numpy(opt.mu[k])
            flat[f".{name}/.nu/{key}"] = to_numpy(opt.nu[k])
    if state.ema is not None:
        for k, e in state.ema.items():
            flat[f".ema/{jax_key(k)}"] = to_numpy(e)
    return flat


def _take(flat: Dict[str, np.ndarray], key: str, like: torch.Tensor) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf: {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != expected {tuple(like.shape)}")
    return from_numpy(arr, like.dtype)


@torch.no_grad()
def load_state(state, flat: Dict[str, np.ndarray]):
    """Copy a flat train checkpoint into ``state`` in place (each tensor
    keeps its device and dtype) and return it. A missing key raises
    KeyError, a misshapen one ValueError; extra keys are ignored."""
    for n, p in state.model.named_parameters():
        p.copy_(_take(flat, f".params/{jax_key(n)}", p))
    for name in ("opt_g", "opt_d", "opt_a"):
        opt = getattr(state, name)
        for k in opt.mu:
            key = jax_key(k)
            count = f".{name}/.count/{key}"
            if count not in flat:
                raise KeyError(f"checkpoint missing leaf: {count}")
            opt.count[k] = int(np.asarray(flat[count]))
            opt.mu[k].copy_(_take(flat, f".{name}/.mu/{key}", opt.mu[k]))
            opt.nu[k].copy_(_take(flat, f".{name}/.nu/{key}", opt.nu[k]))
    if state.ema is not None:
        for k, e in state.ema.items():
            e.copy_(_take(flat, f".ema/{jax_key(k)}", e))
    return state


class Checkpointer:
    """Tag-based checkpoints in one directory."""

    def __init__(self, directory: str):
        self.directory = directory

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"ckpt-{tag}.npz")

    def save(self, tag: str, state, status: Optional[Dict[str, Any]] = None) -> str:
        """Write a TrainState atomically under ``tag``, then ``status`` to
        ``status.json``."""
        return self.save_flat(tag, flatten_state(state), status)

    def save_flat(self, tag: str, flat: Dict[str, np.ndarray], status: Optional[Dict[str, Any]] = None) -> str:
        """Write arrays under their path keys atomically as ``tag`` (a
        weights-only export holds the bare parameter keys), then ``status``."""
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(tag))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if status is not None:
            _write_status(self.directory, status)
        return self._path(tag)

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

    def restore(self, tag: str, state):
        return load_state(state, self.restore_flat(tag))

    def restore_latest(self, state) -> Tuple[Optional[Any], Dict[str, Any]]:
        """(``state`` filled from the latest checkpoint, or None; the status).
        A status that lags an epoch checkpoint (a kill between the rename
        and the status write) is moved on to that epoch, batch 0."""
        tag = self.latest_tag()
        if tag is None:
            return None, {}
        state = self.restore(tag, state)
        status_path = os.path.join(self.directory, "status.json")
        status: Dict[str, Any] = {}
        if os.path.isfile(status_path):
            with open(status_path) as f:
                status = json.load(f)
        if tag.isdigit() and int(status.get("epoch", 1)) <= int(tag):
            print(
                f"WARNING: status.json lags checkpoint {tag} (crash between "
                f"checkpoint rename and status write); resuming at epoch "
                f"{int(tag) + 1} with the stale global_step {status.get('step', 0)}"
            )
            status = {**status, "epoch": int(tag) + 1, "batch": 0}
        return state, status

    def epoch_tags(self) -> list:
        """Numeric (epoch) tags, ascending."""
        names = os.listdir(self.directory) if os.path.isdir(self.directory) else []
        return sorted(int(m.group(1)) for m in (re.match(r"ckpt-(\d+)\.npz$", fn) for fn in names) if m)

    def delete(self, tag) -> None:
        try:
            os.remove(self._path(str(tag)))
        except FileNotFoundError:
            pass


def make_checkpointer(cfg, directory: str) -> Checkpointer:
    if getattr(cfg, "extra", {}).get("checkpoint_backend") == "orbax":
        raise NotImplementedError("the port reads and writes npz checkpoints only, not orbax ones")
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
