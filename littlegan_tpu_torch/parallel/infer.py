"""Data-parallel inference over the cards of one process, the port of
littlegan_tpu/parallel/infer.py.

evaluate-sample's generation, the Inception features of the FID stack and
the serving engine split their batches row-wise over the visible cards. The
forwards are row-independent (the instance norm reduces per sample), so
the split gives the single-card outputs.

:func:`data_parallel_infer` keeps one replica of the weights on each card,
copied once per weights object (and ``version``), cuts each call's rows into
one equal part per card (zero rows pad a ragged batch), launches every
card's part before it waits on any, and concatenates the outputs on the
first card. One process only: under a process group each rank has its own
card, and inference spans that one (:func:`infer_mesh_devices` is 1), as
the JAX package's is 1 under several processes.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map


def infer_mesh_devices(device=None) -> int:
    """Cards a data-parallel inference wrapper would span (1 = disabled):
    every visible card when no process group runs and the work is on a
    card (``device``, default the card), else 1."""
    if device is not None and torch.device(device).type != "cuda":
        return 1
    if dist.is_available() and dist.is_initialized():
        return 1
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1


def pad_rows(arr, target: int):
    """Zero rows appended to axis 0 up to ``target`` (numpy or torch)."""
    pad = target - arr.shape[0]
    if pad <= 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((pad, *arr.shape[1:]))])
    return np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])


def _replicate(params, device: torch.device):
    """A copy of ``params`` on ``device``: a module (as an inference-only
    copy) or a tree of tensors."""
    if isinstance(params, torch.nn.Module):
        return copy.deepcopy(params).to(device).requires_grad_(False).eval()
    return tree_map(lambda x: x.to(device, copy=True) if isinstance(x, torch.Tensor) else x, params)


def _to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


def data_parallel_infer(fn: Callable, n_batch_args: int, devices: Optional[Sequence] = None) -> Callable:
    """Wrap ``fn(params, *batch_args)`` to split its batches over ``devices``
    (default: every visible card).

    - ``params`` (a module or a tree of tensors) is copied to each device
      once per object: a one-slot cache holds a strong reference to it and
      compares identity with ``is``. A bare ``id()`` could be reused by
      CPython for another object once the first is freed, and then serve
      stale weights; a new object evicts the old replicas. The port updates
      weights in place, so a caller whose weights change under the same
      object passes a ``version`` that changes with them.
    - Every batch argument (numpy or torch) splits on axis 0 into one equal
      part per device, zero-padded up to the next multiple of their count;
      outputs are sliced back.
    - ``fn`` runs on each device's part under that device (each part is
      launched before any is waited on), and every output leaf, which must
      carry the batch on axis 0, is concatenated on the first device.

    Two entries of ``devices`` may name one card (two replicas there)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs: List[torch.device] = [torch.device(d) for d in devices]
    if not devs:
        raise RuntimeError("data_parallel_infer: no device to run on")
    n = len(devs)
    cache: dict = {}

    def wrapped(params, *batch_args, version=None):
        if len(batch_args) != n_batch_args:
            raise TypeError(f"expected {n_batch_args} batch args, got {len(batch_args)}")
        cached = cache.get("params")
        if cached is None or cached[0] is not params or cached[1] != version:
            cache.clear()  # drop the old replicas before making the new ones
            cached = (params, version, [_replicate(params, d) for d in devs])
            cache["params"] = cached
        rows = batch_args[0].shape[0]
        per = max(math.ceil(rows / n), 1)
        args = [pad_rows(a, per * n) for a in batch_args]
        outs = []
        with torch.inference_mode():
            for i, d in enumerate(devs):
                part = [_to(a[i * per:(i + 1) * per], d) for a in args]
                with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                    outs.append(fn(cached[2][i], *part))
            out = tree_map(lambda *xs: torch.cat([x.to(devs[0], non_blocking=True) for x in xs]), *outs)
        return tree_map(lambda o: o[:rows], out) if per * n != rows else out

    wrapped.devices = devs  # introspection for tests and logs
    return wrapped
