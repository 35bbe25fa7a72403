"""ZeRO-1, the port of littlegan_tpu/parallel/zero.py: the Adam moments
sharded over the ranks (``Config.shard_opt_state``), and the dense heads
sharded over a spatial mesh's model axis (``Config.shard_dense``).

Plain DP keeps the weights and both Adam moments whole on every card. With
``shard_opt_state`` each rank keeps a part of every moment leaf that
:func:`_moment_spec` shards (JAX's rule over the mesh ``{'data': D}`` or
``{'data': D, 'model': M}``: the largest axis divisible by every rank,
ties to the last such axis, else by the data ranks alone; leaves under
``_MIN_SHARD_ELEMS`` elements stay whole) and one update runs as the JAX
package's partitioner schedules it:

1. the gradients of the leaves sharded over every rank are
   reduce-scattered, so each rank receives the global gradient of its
   part only; the other leaves (and the losses) are all-reduced as in
   :class:`~.train.GradSync` (a leaf sharded over the data ranks alone then
   keeps its data rank's part);
2. D's clamp, then the masked Adam (host or row form, the counts kept whole
   on every rank) updates each rank's part of the weights;
3. the updated parts are all-gathered back into the whole weights.

A reduce-scatter and an all-gather move what one all-reduce moves, and the
moments take 1/n of their memory per card. The weights and the EMA stay
whole: every conv reads them. A checkpoint gathers the parts
(:meth:`Zero1.full_state`), so the npz holds the whole state, as the JAX
package's does.

``shard_dense`` keeps of each dense-head leaf of ``DENSE_HEAD_SPECS`` only
this rank's part along the model axis (:func:`shard_dense_state`): G's and
the adjuster's kernels and biases their output columns, D's head kernels
their input rows, with their moments and EMA alike, whether or not
``shard_opt_state`` is on. The spatial step computes with the parts
(``parallel/spatial.py``); their gradients meet over the data axis only.
A checkpoint gathers them to whole leaves, and a restore (into the whole
state, before :func:`shard_dense_state`) slices them again.
:func:`state_bytes_report` is the JAX function's arithmetic, shape only, for
either flag and any mesh shape.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from torch import nn

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.parallel.mesh import DataGroup
from littlegan_tpu_torch.parallel.spatial import DENSE_AXES, DENSE_HEAD_SPECS as _DENSE_HEAD_SPECS
from littlegan_tpu_torch.parallel.train import BUCKET_BYTES, GradSync, _buckets

# leaves below this element count stay whole (JAX zero.py:81): a sharded
# leaf swaps one all-reduce for a reduce-scatter and an all-gather
_MIN_SHARD_ELEMS = 32768

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


def check_shard_opt_state(cfg: Config, dg: Optional[DataGroup]) -> None:
    """``shard_opt_state`` needs ranks to shard over (JAX ``zero.py:255``)."""
    if cfg.shard_opt_state and (dg is None or dg.world < 2):
        raise ValueError(
            "shard_opt_state=true needs a device mesh (it shards the Adam moments over the data-parallel "
            "ranks): run with torchrun over >1 process and a batch_size divisible by their count, or turn it off"
        )


def check_shard_dense(cfg: Config, dg: Optional[DataGroup]) -> None:
    """``shard_dense`` needs a ('data', 'model') mesh whose model axis
    divides ``init_dim`` (JAX ``zero.py:285-307``): the parts must fall on
    whole H-rows of the reshaped map."""
    if not cfg.shard_dense:
        return
    if dg is None or not hasattr(dg, "model"):
        raise ValueError(
            "shard_dense=true needs a ('data','model') mesh: the dense-head kernels shard over the spatial "
            "mesh's 'model' axis so their shards align with the H-sharded activations — set "
            "mesh_axes=['data','model'] (parallel/spatial.py), or turn shard_dense off"
        )
    n_model = dg.model_size
    if cfg.init_dim % n_model != 0:
        raise ValueError(
            f"shard_dense=true needs init_dim ({cfg.init_dim}) divisible by the model-axis size ({n_model}): "
            "dense-head shard boundaries must fall on whole H-rows of the reshaped feature map so they "
            "coincide with the spatial H-sharding — shrink the model axis or turn shard_dense off"
        )


def _dense_module(model, name: str) -> Tuple[nn.Module, str]:
    path, leaf = name.rsplit(".", 1)
    return model.get_submodule(path), leaf


def _model_part(t: torch.Tensor, axis: int, mg: DataGroup) -> torch.Tensor:
    n = t.shape[axis] // mg.world
    return t.narrow(axis, mg.rank * n, n).clone()


def _model_whole(t: torch.Tensor, axis: int, mg: DataGroup) -> torch.Tensor:
    """Every model rank's part ``t`` joined along ``axis`` (a collective)."""
    t = t.detach().contiguous()
    out = torch.empty((mg.world, *t.shape), dtype=t.dtype, device=t.device)
    mg.all_gather(out.view(-1), t.view(-1))
    return torch.cat(out.unbind(0), axis)


@torch.no_grad()
def shard_dense_state(state, dg) -> None:
    """Keep of each dense-head leaf only this rank's part along the model
    axis, in place: the parameter (a new ``nn.Parameter`` on its module),
    its Adam moments and its EMA copy."""
    mg = dg.model
    for name, axis in DENSE_AXES.items():
        mod, leaf = _dense_module(state.model, name)
        setattr(mod, leaf, nn.Parameter(_model_part(getattr(mod, leaf), axis, mg)))
        for opt in _OPTS:
            adam = getattr(state, opt)
            if name in adam.mu:
                adam.mu[name] = _model_part(adam.mu[name], axis, mg)
                adam.nu[name] = _model_part(adam.nu[name], axis, mg)
        if state.ema is not None and name in state.ema:
            state.ema[name] = _model_part(state.ema[name], axis, mg)


@torch.no_grad()
def dense_whole_state(state, dg, moments: bool = True):
    """``state`` with every dense-head leaf whole (a collective over the
    model axis): a new model holding the whole leaves beside the live ones,
    the EMA and, with ``moments``, the Adam moments gathered alike (else
    left as they are). What a checkpoint holds, and inference reads."""
    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.training.optimizer import AdamState

    mg = dg.model
    params = {k: p.detach() for k, p in state.model.named_parameters()}  # the live storage, not the live Parameters
    params.update({k: _model_whole(params[k], axis, mg) for k, axis in DENSE_AXES.items()})
    with torch.device("meta"):
        model = LittleGAN(state.model.cfg)
    model.load_state_dict(params, strict=False, assign=True)
    for k, b in state.model.named_buffers():  # the s2d indices (not in the state dict)
        mod, leaf = _dense_module(model, k)
        setattr(mod, leaf, b)

    def whole(adam):
        mu, nu = dict(adam.mu), dict(adam.nu)
        for k, axis in DENSE_AXES.items():
            if k in mu:
                mu[k], nu[k] = _model_whole(mu[k], axis, mg), _model_whole(nu[k], axis, mg)
        return AdamState(adam.count, mu, nu)

    ema = None
    if state.ema is not None:
        ema = {k: _model_whole(e, DENSE_AXES[k], mg) if k in DENSE_AXES else e for k, e in state.ema.items()}
    opts = {opt: whole(getattr(state, opt)) for opt in _OPTS} if moments else {}
    return state._replace(model=model, ema=ema, **opts)


def state_parts(sync: Optional[GradSync], state) -> Dict[str, Tuple[int, int, int]]:
    """The flat checkpoint keys (``training/checkpoint.py``) of the leaves
    of which this rank holds a part, each with (axis, index, count): with
    ``shard_dense`` the dense heads' parameters, moments and EMA (along
    their model axis, index the model rank), with ZeRO-1 the sharded
    moments (index the rank in the leaf's group). What the orbax backend's
    ranks each save of their own."""
    from littlegan_tpu_torch.compat.jax_params import jax_key  # it imports the model, which imports this

    out: Dict[str, Tuple[int, int, int]] = {}
    if sync is None:
        return out

    def put(k: str, part: Tuple[int, int, int], weights: bool) -> None:
        key = jax_key(k)
        for opt in _OPTS:
            if k in getattr(state, opt).mu:
                out[f".{opt}/.mu/{key}"] = out[f".{opt}/.nu/{key}"] = part
        if weights:
            out[f".params/{key}"] = part
            if state.ema is not None and k in state.ema:
                out[f".ema/{key}"] = part

    for k in sync.dense:
        put(k, (DENSE_AXES[k], sync.dg.model.rank, sync.dg.model.world), True)
    for k, axis in getattr(sync, "axes", {}).items():
        if axis is not None:
            g = sync._group(k)
            put(k, (axis, g.rank, g.world), False)
    return out


def _split(shape: Sequence[int], axis: int, n: int) -> Tuple[int, int, int]:
    """(elements before ``axis``, its size / n, elements after)."""
    return math.prod(shape[:axis]), shape[axis] // n, math.prod(shape[axis + 1:])


class Zero1(GradSync):
    """:class:`GradSync` with the moments sharded. Built on a replicated
    state (its dense heads already sharded with ``shard_dense``), it
    replaces the sharded leaves' moments by this rank's part: ``axes`` maps
    a leaf to its shard axis (None: whole); a sharded leaf is split over
    every rank, or under a spatial mesh, where JAX's spec says so, over the
    data ranks alone (``over_data``)."""

    def __init__(self, dg: DataGroup, state, shard_dense: bool = False):
        super().__init__(dg, shard_dense)
        mesh = {"data": dg.data_size, "model": dg.model_size} if hasattr(dg, "model") else {"data": dg.world}
        self.axes: Dict[str, Optional[int]] = {}
        self.over_data: set = set()
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        for opt in _OPTS:
            adam = getattr(state, opt)
            for k, m in adam.mu.items():
                self.shapes[k] = tuple(m.shape)
                spec = () if k in self.dense else _moment_spec(m.shape, mesh)
                self.axes[k] = next((i for i, e in enumerate(spec) if e is not None), None)
                if self.axes[k] is not None:
                    if spec[self.axes[k]] == "data" and len(mesh) > 1:
                        self.over_data.add(k)
                    adam.mu[k] = self.shard(m, k)
                    adam.nu[k] = self.shard(adam.nu[k], k)

    def _group(self, k: str) -> DataGroup:
        """The ranks leaf ``k`` is sharded over."""
        return self.dg.data if k in self.over_data else self.dg

    def shard(self, t: torch.Tensor, k: str) -> torch.Tensor:
        """This rank's part of leaf ``k``'s whole tensor ``t`` (a copy)."""
        axis, g = self.axes[k], self._group(k)
        pre, c, post = _split(self.shapes[k], axis, g.world)
        shard_shape = self.shapes[k][:axis] + (c,) + self.shapes[k][axis + 1:]
        return t.reshape(pre, g.world, c, post)[:, g.rank].reshape(shard_shape).clone()

    def _rank_major(self, t: torch.Tensor, k: str) -> torch.Tensor:
        """(n, numel / n): row r is rank r's part of ``t``, flat."""
        n = self._group(k).world
        pre, c, post = _split(self.shapes[k], self.axes[k], n)
        return t.reshape(pre, n, c * post).transpose(0, 1).reshape(n, -1)

    def _whole(self, rows: torch.Tensor, k: str) -> torch.Tensor:
        """The inverse of :meth:`_rank_major`: (n, numel / n) -> the leaf's shape."""
        n = self._group(k).world
        pre, c, post = _split(self.shapes[k], self.axes[k], n)
        return rows.reshape(n, pre, c * post).transpose(0, 1).reshape(self.shapes[k])

    def _sharded(self, names, group=None) -> List[str]:
        """The leaves of ``names`` sharded (over ``group``, when given)."""
        return [k for k in names if self.axes.get(k) is not None and (group is None or self._group(k) is group)]

    def reduce(self, grads: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]):
        """(each sharded leaf's mean gradient part and each whole leaf's
        mean gradient, aux with the losses averaged)."""
        scattered = self._sharded(grads, self.dg)  # in the gradients' order, the same on every rank
        whole = [k for k in grads if k not in scattered and k not in self.dense]
        losses = torch.stack([aux[k].float().reshape(()) for k in self.LOSSES])
        out, losses = self._all_reduce_mean(whole, grads, losses)
        reduced = self.reduced_bytes
        for k in self._sharded(whole):  # sharded over the data ranks alone: keep this data rank's part
            out[k] = self.shard(out[k], k)
        for bucket in _buckets(scattered, grads, BUCKET_BYTES):
            inp = torch.cat([self._rank_major(grads[k], k) for k in bucket], 1)
            shards = torch.empty(inp.shape[1], dtype=inp.dtype, device=inp.device)
            self.dg.reduce_scatter_sum(shards, inp.reshape(-1))
            shards.div_(self.dg.data_size)
            reduced += inp.numel() * inp.element_size()
            off = 0
            for k in bucket:
                n = grads[k].numel() // self.dg.world
                shape = list(self.shapes[k])
                shape[self.axes[k]] //= self.dg.world
                out[k] = shards[off:off + n].view(shape)
                off += n
        out.update(self._reduce_dense(grads))
        self.reduced_bytes = reduced + self.dense_bytes
        return out, {**aux, **dict(zip(self.LOSSES, losses.unbind()))}

    def local_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The tensors this rank's Adam updates: a copy of its part of each
        sharded weight, the whole weight otherwise."""
        return {k: self.shard(p.detach(), k) if self.axes.get(k) is not None else p for k, p in params.items()}

    def _gathered(self, names: List[str], tensors: Dict[str, torch.Tensor]):
        """(leaf, its whole tensor) for each sharded leaf of ``names``, from
        every rank's part in ``tensors`` (all-gathers over each leaf's ranks)."""
        for group in {id(self._group(k)): self._group(k) for k in self._sharded(names)}.values():
            for bucket in _buckets(self._sharded(names, group), tensors, BUCKET_BYTES):
                inp = torch.cat([tensors[k].reshape(-1) for k in bucket])
                rows = torch.empty(group.world * inp.numel(), dtype=inp.dtype, device=inp.device)
                rows = group.all_gather(rows, inp).view(group.world, -1)
                off = 0
                for k in bucket:
                    n = tensors[k].numel()
                    yield k, self._whole(rows[:, off:off + n], k)
                    off += n

    @torch.no_grad()
    def gather(self, params: Dict[str, torch.Tensor], local: Dict[str, torch.Tensor]) -> None:
        """Every rank's updated parts all-gathered into the whole weights."""
        for k, w in self._gathered(list(params), local):
            params[k].copy_(w)

    def full_state(self, state):
        """``state`` with every moment whole (gathered from the ranks; a
        collective) and, with ``shard_dense``, the dense heads whole: what a
        checkpoint holds."""
        from littlegan_tpu_torch.training.optimizer import AdamState

        def whole(adam):
            mu, nu = dict(adam.mu), dict(adam.nu)
            for d in (mu, nu):
                d.update(dict(self._gathered(list(d), d)))
            return AdamState(adam.count, mu, nu)

        return super().full_state(state._replace(**{opt: whole(getattr(state, opt)) for opt in _OPTS}))
