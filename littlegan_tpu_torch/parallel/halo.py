"""The spatial mesh's collectives along the model axis, as autograd Functions.

Under a ``('data', 'model')`` mesh XLA's SPMD partitioner inserts the halo
exchange around every convolution of an H-sharded map, the cross-shard
all-reduce inside every instance norm and the gradients' reductions
(JAX ``parallel/spatial.py``). Here each is written by hand.

Every tensor of a step is either this rank's rows of a map (H-sharded) or
the same on every model rank (replicated), and its gradient keeps that
form: the gradient of a rank's rows is the whole gradient of those rows,
and the gradient of a replicated tensor is the whole gradient, the same on
every model rank. Each Function below keeps that invariant, which fixes its
backward:

- :func:`all_reduce` sums partial values into a replicated one (a
  logit from a rank's rows, an L1 sum). Everything after it is replicated,
  so its gradient is already whole: the backward is the identity.
- :func:`sum_moments` sums partial values that each rank then uses on its
  own rows (the norm's moments, the contrast's mean). Each rank's gradient
  of the sum holds its own rows' share only: the backward sums them.
  (``torch.distributed.nn.functional.all_reduce``'s rule; it is wrong for
  :func:`all_reduce`, where it would count the gradient model-size times.)
- :func:`gather_h` makes a replicated map of every rank's rows (a stage too
  small to tile); the backward takes this rank's rows of the whole gradient.
- :func:`slice_h` takes this rank's rows of a replicated map; the backward
  all-gathers every rank's rows of the gradient.
- :func:`halo_h` gives this rank's rows with ``lo`` rows before and ``hi``
  after (zeros beyond the map's edges), from as many neighbours as it takes;
  the backward sends each borrowed row's gradient back to its owner, who
  adds it to its own.
- :func:`scale_grad` is the identity with the gradient times ``s``: a
  parameter read by a replicated stage gets its whole gradient on every
  model rank, and the gradients meet in one sum over the model axis.

Each backward is built from these same Functions, the transpose of each
being another, so the gradient penalty's ``create_graph=True`` second
derivative sees through them. ``mg`` is the model axis, a
:class:`~littlegan_tpu_torch.parallel.mesh.DataGroup` whose ``rank`` and
``world`` are the model index and size; a CUDA tensor under gloo is staged
through host memory by its methods.
"""

from __future__ import annotations

import torch
from torch.autograd import Function


def _gather(mg, x: torch.Tensor) -> torch.Tensor:
    """(...) -> (world, ...): every model rank's ``x``, in rank order."""
    x = x.contiguous()
    out = torch.empty((mg.world, *x.shape), dtype=x.dtype, device=x.device)
    mg.all_gather(out.view(-1), x.view(-1))
    return out


def _reduce_scatter(mg, x: torch.Tensor) -> torch.Tensor:
    """(world, ...) -> (...): the sum over the model ranks of their ``x[rank]``."""
    x = x.contiguous()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    mg.reduce_scatter_sum(out.view(-1), x.view(-1))
    return out


class _AllGather(Function):
    """Every rank's ``x`` for this rank's own use; backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _gather(mg, x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.mg), None


class _ReduceScatter(Function):
    """The transpose of :class:`_AllGather`."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _reduce_scatter(mg, x)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.mg), None


class _GatherRep(Function):
    """Every rank's ``x`` as one replicated tensor; backward: this rank's part."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _gather(mg, x)

    @staticmethod
    def backward(ctx, g):
        return _SliceRep.apply(g, ctx.mg), None


class _SliceRep(Function):
    """This rank's part ``x[rank]`` of a replicated (world, ...) tensor; the
    transpose of :class:`_GatherRep`."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x[mg.rank].clone()

    @staticmethod
    def backward(ctx, g):
        return _GatherRep.apply(g, ctx.mg), None


class _AllReduce(Function):
    """The sum over the model ranks; backward: the identity (:class:`_Copy`)."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return mg.all_reduce_sum_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mg), None


class _Copy(Function):
    """The identity; backward: the sum over the model ranks. The transpose of :class:`_AllReduce`."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mg), None


class _ScaleGrad(Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def all_reduce(x: torch.Tensor, mg) -> torch.Tensor:
    """The sum over the model ranks of their partial ``x``, replicated."""
    return _AllReduce.apply(x, mg)


def sum_moments(x: torch.Tensor, mg) -> torch.Tensor:
    """The sum over the model ranks of their partial ``x``, which each rank
    then uses on its own rows."""
    return _Copy.apply(_AllReduce.apply(x, mg), mg)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    return _ScaleGrad.apply(x, s)


def gather_h(x: torch.Tensor, mg) -> torch.Tensor:
    """(N, h, ...) rows of each rank -> the replicated (N, world * h, ...) map."""
    y = _GatherRep.apply(x.movedim(1, 0), mg)  # (world, h, N, ...)
    return y.reshape(mg.world * x.shape[1], *y.shape[2:]).movedim(0, 1)


def slice_h(x: torch.Tensor, mg) -> torch.Tensor:
    """A replicated (N, H, ...) map -> this rank's (N, H / world, ...) rows."""
    h = x.shape[1] // mg.world
    y = x.movedim(1, 0).reshape(mg.world, h, x.shape[0], *x.shape[2:])
    return _SliceRep.apply(y, mg).movedim(0, 1)


def halo_h(x: torch.Tensor, lo: int, hi: int, mg) -> torch.Tensor:
    """This rank's (N, h, ...) rows of an H-sharded map with ``lo`` rows
    before and ``hi`` after: (N, lo + h + hi, ...), zeros beyond the map's
    first and last rows. One all-gather of each rank's edge strips (its
    first ``min(h, hi)`` and last ``min(h, lo)`` rows); a halo deeper than a
    rank's rows reaches as many ranks away as it takes. The borrowed rows,
    zeros included, are cut from one tensor padded with zero strips beyond
    the edge ranks, so that every rank's backward reaches the all-gather:
    an edge rank that borrows zeros only still takes part in its
    reduce-scatter."""
    h, j, m = x.shape[1], mg.rank, mg.world
    a, b = min(h, hi), min(h, lo)
    if a + b == 0:
        return x
    strips = _AllGather.apply(torch.cat([x[:, :a], x[:, h - b:]], 1).movedim(1, 0), mg)  # (m, a + b, N, ...)
    before, after = -(-lo // h), -(-hi // h)  # the ranks reached on each side
    zeros = strips.new_zeros(1, *strips.shape[1:])
    strips = torch.cat([zeros.expand(before, *zeros.shape[1:]), strips, zeros.expand(after, *zeros.shape[1:])])
    strips = strips.movedim(2, 1)  # (before + m + after, N, a + b, ...); rank o at before + o
    parts = []
    if lo:
        parts.append(torch.cat([strips[before + o, :, a:] for o in range(j - before, j)], 1)[:, -lo:])
    parts.append(x)
    if hi:
        parts.append(torch.cat([strips[before + o, :, :a] for o in range(j + 1, j + 1 + after)], 1)[:, :hi])
    return torch.cat(parts, 1)
