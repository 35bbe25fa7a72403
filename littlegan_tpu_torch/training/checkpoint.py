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

A StarGAN v2 state (``training/state.py::StarGANState``) is stored the same
way under its own Adams' names (``.opt_g``, ``.opt_f``, ``.opt_e``,
``.opt_d``) and its EMA of G, F and E; every function here takes either
state, by its ``OPTS``.

:class:`Checkpointer` writes a port :class:`TrainState` under those keys and
layouts, so a checkpoint of either package restores in the other. A save
writes a temporary file in the same directory, fsyncs it and renames it
over the tag; ``status.json`` is written the same way.
:func:`eval_params` turns either kind into the parameters inference serves,
with the ``.ema/*`` arrays over the live ones.

:class:`OrbaxCheckpointer` is the counterpart of the JAX package's orbax
backend (``extra.checkpoint_backend = 'orbax'``), built on
``torch.distributed.checkpoint`` (DCP): one ``ocp-<tag>`` directory per
checkpoint, the same flat keys as tensors, saved asynchronously. Neither
package reads the other's directories (orbax imports JAX).
"""

from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import tempfile
import time
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
    """A port TrainState (or StarGANState) under the JAX package's flat keys."""
    flat = {f".params/{jax_key(n)}": to_numpy(p) for n, p in state.model.named_parameters()}
    for name in state.OPTS:
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


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """The tensors of :func:`flatten_state` under the same keys, as they
    lie (this rank's part where a leaf is sharded), the counts as int32
    scalars."""
    flat = {f".params/{jax_key(n)}": p.detach() for n, p in state.model.named_parameters()}
    for name in state.OPTS:
        opt = getattr(state, name)
        for k in opt.mu:
            key = jax_key(k)
            flat[f".{name}/.count/{key}"] = torch.tensor(opt.count[k], dtype=torch.int32)
            flat[f".{name}/.mu/{key}"] = opt.mu[k]
            flat[f".{name}/.nu/{key}"] = opt.nu[k]
    if state.ema is not None:
        for k, e in state.ema.items():
            flat[f".ema/{jax_key(k)}"] = e
    return flat


def _take(flat: Dict[str, Any], key: str, like: torch.Tensor) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf: {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key} shape {tuple(arr.shape)} != expected {tuple(like.shape)}")
    if isinstance(arr, torch.Tensor):
        return arr.to(like.dtype)
    return from_numpy(arr, like.dtype)


@torch.no_grad()
def load_state(state, flat: Dict[str, Any]):
    """Copy a flat train checkpoint (numpy arrays or tensors) into
    ``state`` in place (each tensor keeps its device and dtype) and return
    it. A missing key raises KeyError, a misshapen one ValueError; extra
    keys are ignored."""
    for n, p in state.model.named_parameters():
        p.copy_(_take(flat, f".params/{jax_key(n)}", p))
    for name in state.OPTS:
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


def _read_status(directory: str) -> Dict[str, Any]:
    path = os.path.join(directory, "status.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _reconcile(tag: str, status: Dict[str, Any], window: str) -> Dict[str, Any]:
    """A status that lags epoch checkpoint ``tag`` (a kill in ``window``)
    moved on to that epoch, batch 0, with the JAX package's warning."""
    if tag.isdigit() and int(status.get("epoch", 1)) <= int(tag):
        print(
            f"WARNING: status.json lags checkpoint {tag} (crash between "
            f"{window}); resuming at epoch "
            f"{int(tag) + 1} with the stale global_step {status.get('step', 0)}"
        )
        status = {**status, "epoch": int(tag) + 1, "batch": 0}
    return status


class Checkpointer:
    """Tag-based checkpoints in one directory."""

    def __init__(self, directory: str):
        self.directory = directory

    def wait(self) -> None:
        """Nothing to wait for: a save is done when it returns (the orbax
        counterpart's API)."""

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
        return state, _reconcile(tag, _read_status(self.directory), "checkpoint rename and status write")

    def epoch_tags(self) -> list:
        """Numeric (epoch) tags, ascending."""
        names = os.listdir(self.directory) if os.path.isdir(self.directory) else []
        return sorted(int(m.group(1)) for m in (re.match(r"ckpt-(\d+)\.npz$", fn) for fn in names) if m)

    def delete(self, tag) -> None:
        try:
            os.remove(self._path(str(tag)))
        except FileNotFoundError:
            pass


# a leaf of which each rank saves a part: the flat key, then the part's
# index, the count of parts and the axis they split
_PART = re.compile(r"^(?P<key>.+)#part(?P<i>\d+)of(?P<n>\d+)axis(?P<axis>\d+)$")


def part_key(key: str, part: Tuple[int, int, int]) -> str:
    """The DCP key under which a rank saves its part ``(axis, index,
    count)`` of leaf ``key``: part ``index`` of ``count`` along ``axis``."""
    axis, index, count = part
    return f"{key}#part{index}of{count}axis{axis}"


def _kwargs(fn, group) -> Dict[str, Any]:
    """A DCP call's group argument: ``group``, or, with none, ``no_dist``
    where the installed torch has it (without it DCP runs alone when no
    process group is initialised)."""
    if group is not None:
        return {"process_group": group}
    return {"no_dist": True} if "no_dist" in inspect.signature(fn).parameters else {}


class OrbaxCheckpointer:
    """The JAX package's ``OrbaxCheckpointer`` over
    ``torch.distributed.checkpoint``: the npz :class:`Checkpointer`'s API,
    with an asynchronous save.

    :meth:`save` first waits for the save before it, then stages the
    tensors to host memory (the time it blocks) and writes them on a
    thread (``dcp.async_save``) into ``ocp-<tag>.tmp-<n>``, a name that the
    tag pattern ``ocp-([A-Za-z0-9_-]+)$`` skips. :meth:`wait` finishes it:
    rank 0 renames the directory to ``ocp-<tag>`` and only then writes
    ``status.json``, so the status never names a checkpoint that did not
    finish, and the ranks meet in a barrier.

    Under a process group (``group``: a gloo group of every rank, kept for
    the saves, whose collectives run on the save's thread) every rank
    calls :meth:`save`, :meth:`wait` and the restores, and writes its own
    parts: a leaf of which a rank holds a part (``parts``: flat key ->
    (axis, index, count), ``parallel/zero.py::state_parts``: ZeRO-1's
    moment shards, ``shard_dense``'s heads) is saved under the rank-
    qualified key :func:`part_key`; a whole leaf under its flat key, which
    DCP writes once. A restore reads, of each leaf, the saved parts that
    overlap this rank's part and cuts it out of them, so a checkpoint
    restores at any other layout (world size, mesh, flags) too."""

    def __init__(self, directory: str, group=None):
        import torch.distributed.checkpoint  # noqa: F401 (a second or more: here, not in the first save)

        self.directory = os.path.abspath(directory)
        self.group = group
        self._pending = None  # (the save's future, its directory, the tag's, the status to write)

    @property
    def _rank(self) -> int:
        import torch.distributed as dist

        return 0 if self.group is None else dist.get_rank(self.group)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"ocp-{tag}")

    def save(self, tag: str, state, status: Optional[Dict[str, Any]] = None,
             parts: Optional[Dict[str, Tuple[int, int, int]]] = None) -> str:
        """Start saving this rank's tensors of ``state`` as ``tag``; the
        status is written by the next :meth:`wait`."""
        parts = parts or {}
        flat = {part_key(k, parts[k]) if k in parts else k: t
                for k, t in state_tensors(state).items()}
        return self._launch(tag, flat, status)

    def save_flat(self, tag: str, flat: Dict[str, np.ndarray], status: Optional[Dict[str, Any]] = None) -> str:
        """Start saving numpy arrays under their keys (a weights-only export)."""
        return self._launch(tag, {k: _tensor(a) for k, a in flat.items()}, status)

    def _launch(self, tag: str, flat: Dict[str, torch.Tensor], status) -> str:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        self.wait()
        os.makedirs(self.directory, exist_ok=True)
        stamp = [time.time_ns()]
        if self.group is not None:  # one partial directory for every rank
            dist.broadcast_object_list(stamp, src=dist.get_global_rank(self.group, 0), group=self.group)
        tmp = f"{self._path(tag)}.tmp-{stamp[0]}"
        future = dcp.async_save(flat, storage_writer=dcp.FileSystemWriter(tmp),
                                **_kwargs(dcp.async_save, self.group))
        self._pending = (future, tmp, self._path(tag), status)
        return self._path(tag)

    def wait(self) -> None:
        """Finish the save in flight, if any: its rename to ``ocp-<tag>``
        (replacing one of the same tag) and the status (rank 0), then a
        barrier of the ranks."""
        if self._pending is None:
            return
        future, tmp, path, status = self._pending
        self._pending = None
        getattr(future, "upload_completion", future).result()  # a Future, or newer torch's AsyncSaveResponse
        if self._rank == 0:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
            if status is not None:
                _write_status(self.directory, status)
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def _read(self, tag: str, want: Optional[Dict[str, torch.Tensor]],
              parts: Dict[str, Tuple[int, int, int]]) -> Dict[str, torch.Tensor]:
        """Each key of ``want`` (None: every saved leaf, whole) as this
        rank holds it: its part ``parts[key]`` or whole, read from the
        saved leaf or from the saved parts that overlap it. Reads alone
        (no collective)."""
        import torch.distributed.checkpoint as dcp

        path = self._path(tag)
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        saved: Dict[str, Optional[Tuple[int, int]]] = {}  # key -> None (whole) or (axis, count of parts)
        for k in meta:
            m = _PART.match(k)
            if m:
                saved[m.group("key")] = (int(m.group("axis")), int(m.group("n")))
            else:
                saved[k] = None
        keys = list(saved) if want is None else list(want)
        plans = {}
        for key in keys:
            if key not in saved:
                raise KeyError(f"checkpoint {path} missing leaf: {key}")
            plans[key] = self._plan(key, saved[key], parts.get(key), meta)
        bufs = {k: torch.empty(tuple(meta[k].size), dtype=meta[k].properties.dtype)
                for plan in plans.values() for k in plan[0]}
        dcp.load(bufs, storage_reader=dcp.FileSystemReader(path), **_kwargs(dcp.load, None))
        out = {}
        for key, (names, axis, cut) in plans.items():
            t = bufs[names[0]] if len(names) == 1 else torch.cat([bufs[k] for k in names], axis)
            out[key] = t if cut is None else t.narrow(*cut)
        return out

    @staticmethod
    def _plan(key: str, saved: Optional[Tuple[int, int]], live: Optional[Tuple[int, int, int]], meta):
        """(the DCP keys to read for ``key``, the axis they join along, and
        the (axis, start, length) of this rank's part in the joined tensor,
        or None to keep it whole)."""
        if saved is None:
            names, axis, offset, shape = [key], None, 0, list(meta[key].size)
        else:
            axis, n = saved
            shape = list(meta[part_key(key, (axis, 0, n))].size)
            size = shape[axis]
            shape[axis] *= n
            first, last = 0, n
            if live is not None and live[0] == axis:  # only the saved parts that overlap this rank's
                per = shape[axis] // live[2]
                first, last = live[1] * per // size, -(-(live[1] + 1) * per // size)
            names, offset = [part_key(key, (axis, j, n)) for j in range(first, last)], first * size
        if live is None:
            return names, axis, None
        la, li, ln = live
        per = shape[la] // ln
        return names, axis, (la, li * per - (offset if la == axis else 0), per)

    def restore(self, tag: str, state, parts: Optional[Dict[str, Tuple[int, int, int]]] = None):
        """Fill ``state`` (this rank's parts: ``parts``) from ``tag``."""
        self.wait()
        return load_state(state, self._read(tag, state_tensors(state), parts or {}))

    def restore_flat(self, tag: str) -> Dict[str, np.ndarray]:
        """Every leaf whole, as numpy arrays by flat key (what
        :meth:`Checkpointer.restore_flat` gives)."""
        self.wait()
        return {k: to_numpy(t) for k, t in self._read(tag, None, {}).items()}

    def latest_tag(self) -> Optional[str]:
        """The tag whose directory is newest; partial directories (a dot
        in the name) are skipped."""
        self.wait()
        if not os.path.isdir(self.directory):
            return None
        tags = {}
        for fn in os.listdir(self.directory):
            m = re.match(r"ocp-([A-Za-z0-9_-]+)$", fn)
            if m and os.path.isdir(os.path.join(self.directory, fn)):
                tags[m.group(1)] = os.path.getmtime(os.path.join(self.directory, fn))
        return max(tags, key=lambda t: tags[t]) if tags else None

    def tag_fingerprint(self, tag: str) -> Optional[float]:
        """Change token for ``tag`` (its directory's mtime)."""
        try:
            return os.path.getmtime(self._path(str(tag)))
        except OSError:
            return None

    def restore_latest(self, state, parts: Optional[Dict[str, Tuple[int, int, int]]] = None):
        """(``state`` filled from the latest checkpoint, or None; the
        status), a status one epoch behind reconciled as the npz
        backend's."""
        tag = self.latest_tag()
        if tag is None:
            return None, {}
        state = self.restore(tag, state, parts)
        return state, _reconcile(tag, _read_status(self.directory), "async commit and status write")

    def epoch_tags(self) -> list:
        """Numeric (epoch) tags, ascending. No wait: pruning old tags must
        not join the save of the newest, which a listing cannot see before
        its rename."""
        names = os.listdir(self.directory) if os.path.isdir(self.directory) else []
        return sorted(int(m.group(1)) for m in (re.match(r"ocp-(\d+)$", fn) for fn in names)
                      if m and os.path.isdir(os.path.join(self.directory, m.group(0))))

    def delete(self, tag) -> None:
        shutil.rmtree(self._path(str(tag)), ignore_errors=True)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor: 2-byte void words as bfloat16."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return from_numpy(arr, torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def make_checkpointer(cfg, directory: str, group=None):
    """The config's backend: npz (default), or ``extra.checkpoint_backend
    = 'orbax'``'s counterpart. ``group``: under a process group, this
    rank's ``DataGroup``: the orbax backend then makes a gloo group of
    every rank for its saves (a collective: every rank calls this)."""
    if getattr(cfg, "extra", {}).get("checkpoint_backend") == "orbax":
        if group is None:
            return OrbaxCheckpointer(directory)
        import torch.distributed as dist

        return OrbaxCheckpointer(directory, dist.new_group(backend="gloo"))
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
