"""Partitioned-training schedule over named parameter groups, the port of
littlegan_tpu/training/partition.py.

The reference rotates training over weight groups (eager_trainer.py:48-52);
by parameter name they are:

    G: [g_head] · [decoder.block1] · [decoder.block2-4 + out_conv]
    D: [encoder.block1-3] · [encoder.block4] · [d_head]
    A: [adj_head]

On batches where ``use_partition and batch_no % (interval + 1) == 0`` only
group ``(batch_no // (interval + 1)) % n_groups`` trains; on the others
every weight does. ``batch_no`` is a host integer here, so a mask is a
Python number per parameter; :func:`mask_rows` gives the masks of K
updates as rows, which a K-update dispatch reads on the device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

_G_GROUPS = [
    ["g_head."],
    ["decoder.block1."],
    ["decoder.block2.", "decoder.block3.", "decoder.block4.", "out_conv."],
]
_D_GROUPS = [
    ["encoder.block1.", "encoder.block2.", "encoder.block3."],
    ["encoder.block4."],
    ["d_head."],
]
_A_GROUPS = [["adj_head."]]


def _rows(names: Iterable[str], groups) -> Dict[str, List[float]]:
    return {n: [1.0 if any(n.startswith(p) for p in grp) else 0.0 for grp in groups] for n in names}


def build_partition_masks(g_names: Iterable[str], d_names: Iterable[str], a_names: Iterable[str]):
    """Per model, ``name -> [0/1 per group]`` for each of its parameters."""
    return {
        "generator": _rows(g_names, _G_GROUPS),
        "discriminator": _rows(d_names, _D_GROUPS),
        "adjuster": _rows(a_names, _A_GROUPS),
    }


def resolve_mask(stacked: Dict[str, List[float]], batch_no: int, use_partition: bool, interval: int):
    """``name -> 0./1.`` for this batch (eager_trainer.py:104-113)."""
    if not use_partition:
        return {k: 1.0 for k in stacked}
    period = interval + 1
    if batch_no % period != 0:
        return {k: 1.0 for k in stacked}
    n_groups = len(next(iter(stacked.values())))
    group = (batch_no // period) % n_groups
    return {k: row[group] for k, row in stacked.items()}


def adjuster_gate(batch_no: int, train_adj: bool) -> float:
    """The adjuster's warm-up gate (eager_trainer.py:152): it trains only
    after batch 10 of every epoch, and never without ``train_adj``."""
    return 1.0 if train_adj and batch_no > 10 else 0.0


def mask_rows(
    part_masks, batch_nos: Sequence[int], use_partition: bool, interval: int, train_adj: bool
) -> Dict[str, np.ndarray]:
    """Per model, the (len(batch_nos), leaves) f32 0/1 rows of the updates
    at ``batch_nos``: :func:`resolve_mask` of each batch number, leaves in
    the order of ``part_masks[model]``; the adjuster's rows are multiplied
    by its warm-up gate."""
    out = {}
    for which, stacked in part_masks.items():
        rows = [list(resolve_mask(stacked, b, use_partition, interval).values()) for b in batch_nos]
        out[which] = np.asarray(rows, np.float32).reshape(len(batch_nos), len(stacked))
    gates = np.asarray([adjuster_gate(b, train_adj) for b in batch_nos], np.float32)
    out["adjuster"] = out["adjuster"] * gates[:, None]
    return out
