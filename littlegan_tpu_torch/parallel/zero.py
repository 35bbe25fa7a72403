"""ZeRO-1, the port of littlegan_tpu/parallel/zero.py: the Adam moments
sharded over the data-parallel ranks (``Config.shard_opt_state``).

Plain DP keeps the weights and both Adam moments whole on every card. With
``shard_opt_state`` each rank keeps 1/n of every moment leaf that
:func:`_moment_spec` shards (JAX's rule: the largest axis divisible by n,
ties to the last such axis; leaves under ``_MIN_SHARD_ELEMS`` elements stay
whole) and one update runs as the JAX package's partitioner schedules it:

1. the gradients of the sharded leaves are reduce-scattered, so each rank
   receives the global mean of its 1/n only; the other leaves (and the
   losses) are all-reduced as in :class:`~.train.GradSync`;
2. D's clamp, then the masked Adam (host or row form, the counts kept whole
   on every rank) updates each rank's shard of the weights;
3. the updated shards are all-gathered back into the whole weights.

A reduce-scatter and an all-gather move what one all-reduce moves, and the
moments take 1/n of their memory per card. The weights and the EMA stay
whole: every conv reads them. A checkpoint gathers the shards
(:meth:`Zero1.full_state`), so the npz holds the whole state, as the JAX
package's does.

``shard_dense`` shards the dense heads over a spatial mesh's ``'model'``
axis, which the port does not have yet (ROADMAP A13): it is refused.
:func:`state_bytes_report` is the JAX function's arithmetic, shape only, for
either flag and any mesh shape.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.parallel.mesh import SPATIAL_TODO, DataGroup
from littlegan_tpu_torch.parallel.train import BUCKET_BYTES, GradSync, _buckets

# leaves below this element count stay whole (JAX zero.py:81): a sharded
# leaf swaps one all-reduce for a reduce-scatter and an all-gather
_MIN_SHARD_ELEMS = 32768

# shard_dense's parameter specs, keyed by path (JAX zero.py:88-95)
_DENSE_HEAD_SPECS = {
    ("g_head", "dense", "kernel"): (None, "model"),
    ("g_head", "dense", "bias"): ("model",),
    ("adj_head", "dense", "kernel"): (None, "model"),
    ("adj_head", "dense", "bias"): ("model",),
    ("d_head", "pr", "kernel"): ("model", None),
    ("d_head", "cond", "kernel"): ("model", None),
}

_OPTS = ("opt_g", "opt_d", "opt_a")


def _moment_spec(shape: Sequence[int], mesh_shape: Dict[str, int]) -> tuple:
    """The JAX ``_moment_spec`` of one moment leaf over a mesh of
    ``{axis: size}``, as a tuple of entries (None, an axis name, or a tuple
    of names); ``()`` is whole. The largest axis divisible by the whole
    mesh (ties: the last such axis, so conv kernels shard their output
    channels), else by the 'data' axis alone; leaves under
    ``_MIN_SHARD_ELEMS`` stay whole."""
    if math.prod(shape) < _MIN_SHARD_ELEMS:
        return ()
    names = tuple(mesh_shape)
    candidates = [names]
    if len(names) > 1 and "data" in names:
        candidates.append(("data",))
    for axes in candidates:
        n = math.prod(mesh_shape[a] for a in axes)
        if n <= 1:
            continue
        best = None
        for i, d in enumerate(shape):
            if d % n == 0 and d > 1 and (best is None or d >= shape[best]):
                best = i
        if best is not None:
            spec = [None] * len(shape)
            spec[best] = axes if len(axes) > 1 else axes[0]
            return tuple(spec)
    return ()


def moment_axis(shape: Sequence[int], world: int) -> Optional[int]:
    """The axis a moment leaf shards over ``world`` data ranks, or None."""
    spec = _moment_spec(tuple(shape), {"data": world})
    return next((i for i, e in enumerate(spec) if e is not None), None)


def _spec_divisor(spec: tuple, mesh_shape: Dict[str, int]) -> int:
    n = 1
    for entry in spec:
        for ax in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh_shape[ax]
    return n


def state_bytes_report(cfg: Config, mesh_shape: Optional[Dict[str, int]] = None) -> dict:
    """The train state's bytes, whole and per card, under the config's
    sharding flags over a mesh of ``{axis: size}`` (None: one card), from
    the shapes alone (the model is built on the meta device). The JAX
    function's arithmetic leaf for leaf: the dense-head specs ignore the
    size threshold, :func:`_moment_spec` applies it; the int32 counts are
    left out."""
    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.training.state import A_KEYS, D_KEYS, G_KEYS

    mesh = dict(mesh_shape) if mesh_shape else None
    dense = mesh is not None and cfg.shard_dense and "model" in mesh
    if dense and cfg.init_dim % mesh["model"] != 0:
        raise ValueError(f"shard_dense needs init_dim ({cfg.init_dim}) divisible by the "
                         f"model-axis size ({mesh['model']})")
    with torch.device("meta"):
        model = LittleGAN(cfg)
    shapes = [(tuple(n.split(".")), tuple(p.shape)) for n, p in model.named_parameters()]
    moment_item = torch.tensor([], dtype=getattr(torch, cfg.moment_dtype)).element_size()

    def leaf(path, shape, item, is_moment):
        total = math.prod(shape) * item
        spec = _DENSE_HEAD_SPECS.get(path) if dense else None
        if spec is None and is_moment and mesh is not None and cfg.shard_opt_state:
            spec = _moment_spec(shape, mesh)
        return total, total // (_spec_divisor(spec, mesh) if spec is not None else 1)

    g_parts = set(G_KEYS)
    opt_parts = set(G_KEYS) | set(D_KEYS) | set(A_KEYS)
    sections = (
        ("params", [(p, s) for p, s in shapes], 4, False, 1),
        ("opt_mu_nu", [(p, s) for p, s in shapes if p[0] in opt_parts], moment_item, True, 2),
        ("ema", [(p, s) for p, s in shapes if p[0] in g_parts] if cfg.ema_decay > 0 else [], 4, False, 1),
    )
    out = {}
    for name, leaves, item, is_moment, copies in sections:
        g = p = 0
        for path, shape in leaves:
            gb, pb = leaf(path, shape, item, is_moment)
            g += copies * gb
            p += copies * pb
        out[name] = {"global_bytes": g, "per_chip_bytes": p}
    parts = list(out.values())
    out["total_per_chip_bytes"] = sum(v["per_chip_bytes"] for v in parts)
    out["total_global_bytes"] = sum(v["global_bytes"] for v in parts)
    return out


class ShardDenseNotPorted(NotImplementedError, ValueError):
    """shard_dense refused: not ported (NotImplementedError), and, as in
    the JAX package, a mesh without a 'model' axis (ValueError)."""


def check_shard_opt_state(cfg: Config, dg: Optional[DataGroup]) -> None:
    """``shard_opt_state`` needs ranks to shard over (JAX ``zero.py:255``)."""
    if cfg.shard_opt_state and (dg is None or dg.world < 2):
        raise ValueError(
            "shard_opt_state=true needs a device mesh (it shards the Adam moments over the data-parallel "
            "ranks): run with torchrun over >1 process and a batch_size divisible by their count, or turn it off"
        )


def check_shard_dense(cfg: Config) -> None:
    """``shard_dense`` needs a ('data', 'model') mesh (JAX ``zero.py:285``),
    which the port does not have yet."""
    if cfg.shard_dense:
        raise ShardDenseNotPorted(
            "shard_dense=true needs a ('data','model') mesh: the dense-head kernels shard over the spatial "
            f"mesh's 'model' axis. {SPATIAL_TODO}, nor is shard_dense; turn shard_dense off"
        )


def _split(shape: Sequence[int], axis: int, n: int) -> Tuple[int, int, int]:
    """(elements before ``axis``, its size / n, elements after)."""
    return math.prod(shape[:axis]), shape[axis] // n, math.prod(shape[axis + 1:])


class Zero1(GradSync):
    """:class:`GradSync` with the moments sharded. Built on a replicated
    state, it replaces the sharded leaves' moments by this rank's shard
    (``axes``: leaf name -> shard axis, or None for a whole leaf)."""

    def __init__(self, dg: DataGroup, state):
        super().__init__(dg)
        self.axes: Dict[str, Optional[int]] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        for opt in _OPTS:
            adam = getattr(state, opt)
            for k, m in adam.mu.items():
                self.shapes[k] = tuple(m.shape)
                self.axes[k] = moment_axis(m.shape, dg.world)
                if self.axes[k] is not None:
                    adam.mu[k] = self.shard(m, k)
                    adam.nu[k] = self.shard(adam.nu[k], k)

    def shard(self, t: torch.Tensor, k: str) -> torch.Tensor:
        """This rank's shard of leaf ``k``'s whole tensor ``t`` (a copy)."""
        axis = self.axes[k]
        pre, c, post = _split(self.shapes[k], axis, self.dg.world)
        shard_shape = self.shapes[k][:axis] + (c,) + self.shapes[k][axis + 1:]
        return t.reshape(pre, self.dg.world, c, post)[:, self.dg.rank].reshape(shard_shape).clone()

    def _rank_major(self, t: torch.Tensor, k: str) -> torch.Tensor:
        """(world, numel / world): row r is rank r's shard of ``t``, flat."""
        pre, c, post = _split(self.shapes[k], self.axes[k], self.dg.world)
        return t.reshape(pre, self.dg.world, c * post).transpose(0, 1).reshape(self.dg.world, -1)

    def _whole(self, rows: torch.Tensor, k: str) -> torch.Tensor:
        """The inverse of :meth:`_rank_major`: (world, numel / world) -> the leaf's shape."""
        pre, c, post = _split(self.shapes[k], self.axes[k], self.dg.world)
        return rows.reshape(self.dg.world, pre, c * post).transpose(0, 1).reshape(self.shapes[k])

    def _sharded(self, names) -> List[str]:
        return [k for k in names if self.axes.get(k) is not None]

    def reduce(self, grads: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]):
        """(each sharded leaf's mean gradient shard and each whole leaf's
        mean gradient, aux with the losses averaged)."""
        whole = [k for k in grads if self.axes.get(k) is None]
        losses = torch.stack([aux[k].float().reshape(()) for k in self.LOSSES])
        out, losses = self._all_reduce_mean(whole, grads, losses)
        whole_bytes = self.reduced_bytes
        for bucket in _buckets(self._sharded(grads), grads, BUCKET_BYTES):
            inp = torch.cat([self._rank_major(grads[k], k) for k in bucket], 1)
            shards = torch.empty(inp.shape[1], dtype=inp.dtype, device=inp.device)
            self.dg.reduce_scatter_sum(shards, inp.reshape(-1))
            shards.div_(self.dg.world)
            whole_bytes += inp.numel() * inp.element_size()
            off = 0
            for k in bucket:
                n = grads[k].numel() // self.dg.world
                shape = list(self.shapes[k])
                shape[self.axes[k]] //= self.dg.world
                out[k] = shards[off:off + n].view(shape)
                off += n
        self.reduced_bytes = whole_bytes
        return out, {**aux, **dict(zip(self.LOSSES, losses.unbind()))}

    def local_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The tensors this rank's Adam updates: a copy of its shard of each
        sharded weight, the whole weight otherwise."""
        return {k: self.shard(p.detach(), k) if self.axes.get(k) is not None else p for k, p in params.items()}

    @torch.no_grad()
    def gather(self, params: Dict[str, torch.Tensor], local: Dict[str, torch.Tensor]) -> None:
        """Every rank's updated shards all-gathered into the whole weights."""
        for bucket in _buckets(self._sharded(params), local, BUCKET_BYTES):
            inp = torch.cat([local[k].reshape(-1) for k in bucket])
            rows = torch.empty(self.dg.world * inp.numel(), dtype=inp.dtype, device=inp.device)
            rows = self.dg.all_gather(rows, inp).view(self.dg.world, -1)
            off = 0
            for k in bucket:
                n = local[k].numel()
                params[k].copy_(self._whole(rows[:, off:off + n], k))
                off += n

    def full_state(self, state):
        """``state`` with every moment whole (gathered from the ranks; a
        collective): what a checkpoint holds."""
        from littlegan_tpu_torch.training.optimizer import AdamState

        def whole(adam):
            mu, nu = dict(adam.mu), dict(adam.nu)
            for k in self._sharded(adam.mu):
                for d in (mu, nu):
                    flat = d[k].reshape(-1)
                    rows = torch.empty(self.dg.world * flat.numel(), dtype=flat.dtype, device=flat.device)
                    d[k] = self._whole(self.dg.all_gather(rows, flat).view(self.dg.world, -1), k)
            return AdamState(adam.count, mu, nu)

        return state._replace(**{opt: whole(getattr(state, opt)) for opt in _OPTS})
