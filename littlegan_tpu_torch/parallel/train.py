"""Data-parallel training, the port's counterpart of littlegan_tpu/parallel/train.py.

Each rank runs the single-card step on its ``batch_size / world`` rows of
every global batch (:func:`shard_local_batch`, :func:`local_draws`), so it
runs the kernels (K1, K1', K2, K3 and their backwards) on its own rows.
The JAX package turns its Pallas kernels off under a mesh
(``parallel/train.py:88-92``) only because XLA's SPMD partitioner cannot
split a Mosaic kernel; a process per card has no such limit, so the port
keeps them on.

The gradients meet in :class:`GradSync`: one averaging all-reduce of every
gradient leaf, flattened into a few buckets, with the three losses riding
in the first so that every rank logs the global batch's. The step calls it
between the backward and the optimizer (``training/step.py``), before the
clamp of D's gradients, which in JAX sees the global gradient. Nothing hooks
``.grad``: the step takes its gradients with ``torch.autograd.grad``, which
``DistributedDataParallel``'s hooks never see.

Every loss is a mean over the rows of a batch and every other op is per
sample (the instance norm reduces over each sample's own axes), so the mean
of the ranks' gradients is the global batch's gradient: DP over n ranks
gives the update one card gives on the global batch, up to the order of
the sums.

Under a ``('data', 'model')`` mesh (:class:`~.mesh.SpatialGroup`) a rank
takes its rows and, of images, its H-slice; the step runs the sharded
forms of ``parallel/spatial.py``, after which every gradient is this
rank's share of its data index's gradient (``Spatial.param`` scales a
replicated stage's). :class:`GradSync` then sums over the model ranks and
averages over the data ranks: one SUM all-reduce over every rank, divided
by the data size. The losses are the same on the model ranks of a data
index, so they are divided by the world. With ``shard_dense`` the dense
heads' parts meet over the data ranks only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from littlegan_tpu_torch.parallel.mesh import DataGroup, h_slice, row_slice

BUCKET_BYTES = 32 << 20  # per flat all-reduce buffer


def shard_local_batch(batch, dg: Optional[DataGroup], axis: int = 0):
    """This rank's rows of each array of a global batch (numpy or torch),
    along ``axis`` (1 for (M, B, ...) accumulation stacks); of an image
    array (B, H, W, C after the leading axes) under a spatial mesh, also
    its H-slice."""
    if dg is None:
        return batch
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_local_batch(x, dg, axis) for x in batch)
    idx = (slice(None),) * axis + (row_slice(batch.shape[axis], dg),)
    if batch.ndim - axis == 4 and getattr(dg, "model_size", 1) > 1:
        idx += (h_slice(batch.shape[axis + 1], dg),)
    return batch[idx]


def local_draws(draws, dg: Optional[DataGroup], lead: int = 0):
    """This rank's rows of a global batch's ``StepDraws`` (stacked over
    ``lead`` leading axes): the per-sample draws are sliced, the batch-wide
    ones (brightness, contrast and hue deltas) are the same on every rank;
    the image-shaped augmentation noise takes its H-slice too."""
    if dg is None:
        return draws
    aug = draws.augment
    rows = lambda x: None if x is None else x[(slice(None),) * lead + (row_slice(x.shape[lead], dg),)]  # noqa: E731
    aug = aug._replace(flip=rows(aug.flip), noise=shard_local_batch(aug.noise, dg, lead))
    return draws._replace(noise=rows(draws.noise), augment=aug, gp_eps=rows(draws.gp_eps))


def _checksums(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One float64 sum of each tensor's values and of their squares."""
    return torch.stack([torch.stack([t.double().sum(), t.double().square().sum()]) for t in tensors]).reshape(-1)


@torch.no_grad()
def replicate_state(state, dg: Optional[DataGroup]):
    """Rank 0's train state on every rank, in place: each tensor (weights,
    moments, EMA) broadcast once and the host counts sent along, then held
    equal on every rank by one checksum all-reduce (the largest of each
    rank's checksum and of its negation must give it back)."""
    if dg is None:
        return state
    from littlegan_tpu_torch.training.step import state_tensors

    tensors = state_tensors(state)
    for t in tensors:
        dg.broadcast_(t)
    counts = dg.broadcast_object({opt: dict(getattr(state, opt).count) for opt in ("opt_g", "opt_d", "opt_a")})
    for opt, c in counts.items():
        getattr(state, opt).count.update(c)
    cs = _checksums(tensors)
    both = torch.cat([cs, -cs]).to(dg.device)
    dg._run(lambda x, group: torch.distributed.all_reduce(x, op=torch.distributed.ReduceOp.MAX, group=group), both)
    if not torch.equal(both.cpu(), torch.cat([cs, -cs]).cpu()):
        raise RuntimeError("replicate_state: the ranks' train states differ after the broadcast")
    return state


def _buckets(names: Sequence[str], tensors: Dict[str, torch.Tensor], cap: int) -> List[List[str]]:
    """``names`` in order, cut into runs of at most ``cap`` bytes (a larger
    leaf gets a run of its own)."""
    out, cur, size = [], [], 0
    for k in names:
        nbytes = tensors[k].numel() * tensors[k].element_size()
        if cur and size + nbytes > cap:
            out.append(cur)
            cur, size = [], 0
        cur.append(k)
        size += nbytes
    if cur:
        out.append(cur)
    return out


class GradSync:
    """The averaging all-reduce of the gradients and losses of one update,
    over a :class:`DataGroup`; every parameter replicated.

    The step calls :meth:`reduce` on the rank's gradients (and aux with the
    losses), updates the tensors :meth:`local_params` gives with Adam, then
    :meth:`gather`\\ s them; here those two do nothing (:class:`Zero1`
    shards the optimizer). ``capturable``: whether the collectives may be
    captured in a CUDA graph (NCCL's can, gloo's cannot). Under a spatial
    mesh (:class:`~.mesh.SpatialGroup`) ``spatial`` is the model axis the
    step shards its maps over (None for a data mesh or a model axis of 1),
    and with ``shard_dense`` the dense heads' parts are reduced apart."""

    LOSSES = ("loss/gen", "loss/disc", "loss/adj")

    def __init__(self, dg: DataGroup, shard_dense: bool = False):
        from littlegan_tpu_torch.parallel.spatial import DENSE_AXES, Spatial

        self.dg = dg
        self.dense = set(DENSE_AXES) if shard_dense else set()  # leaves reduced over the data ranks only
        self.spatial = Spatial(dg.model, shard_dense) if getattr(dg, "model_size", 1) > 1 else None
        self.reduced_bytes = 0  # bytes all-reduced by the last update
        self.dense_bytes = 0  # of which the dense heads' parts

    @property
    def capturable(self) -> bool:
        return self.dg.backend == "nccl"

    def _all_reduce_mean(self, names: Sequence[str], grads: Dict[str, torch.Tensor],
                         extra: Optional[torch.Tensor] = None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(the leaves ``names`` summed over the ranks and divided by the
        data size, as views of flat buffers; ``extra``, the same on the
        model ranks, averaged likewise in the first buffer)."""
        out: Dict[str, torch.Tensor] = {}
        self.reduced_bytes = 0
        extra_out = None
        for i, bucket in enumerate(_buckets(names, grads, BUCKET_BYTES) or [[]]):
            parts = [grads[k].reshape(-1) for k in bucket]
            if i == 0 and extra is not None:
                parts.append(extra)
            flat = torch.cat(parts)
            self.dg.all_reduce_sum_(flat)
            flat.div_(self.dg.data_size)
            self.reduced_bytes += flat.numel() * flat.element_size()
            off = 0
            for k in bucket:
                n = grads[k].numel()
                out[k] = flat[off:off + n].view(grads[k].shape)
                off += n
            if i == 0 and extra is not None:
                extra_out = flat[off:].div_(self.dg.model_size)
        return out, extra_out

    def _reduce_dense(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The dense heads' parts averaged over the data ranks (the model
        ranks hold other parts)."""
        names = [k for k in grads if k in self.dense]
        out: Dict[str, torch.Tensor] = {}
        self.dense_bytes = 0
        for bucket in _buckets(names, grads, BUCKET_BYTES):
            flat = torch.cat([grads[k].reshape(-1) for k in bucket])
            self.dg.data.all_reduce_sum_(flat)
            flat.div_(self.dg.data_size)
            self.dense_bytes += flat.numel() * flat.element_size()
            off = 0
            for k in bucket:
                out[k] = flat[off:off + grads[k].numel()].view(grads[k].shape)
                off += grads[k].numel()
        return out

    def reduce(self, grads: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]):
        """(gradients averaged over the ranks, aux with the losses averaged)."""
        losses = torch.stack([aux[k].float().reshape(()) for k in self.LOSSES])
        out, losses = self._all_reduce_mean([k for k in grads if k not in self.dense], grads, losses)
        out.update(self._reduce_dense(grads))
        self.reduced_bytes += self.dense_bytes
        return out, {**aux, **dict(zip(self.LOSSES, losses.unbind()))}

    def full_state(self, state):
        """``state`` as a checkpoint holds it: with ``shard_dense`` the dense
        heads gathered whole (a collective), else ``state`` itself."""
        if not self.dense:
            return state
        from littlegan_tpu_torch.parallel.zero import dense_whole_state

        return dense_whole_state(state, self.dg)

    def local_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return params

    def gather(self, params: Dict[str, torch.Tensor], local: Dict[str, torch.Tensor]) -> None:
        return None


def global_rows(t: torch.Tensor, dg: Optional[DataGroup], halves: bool = False) -> torch.Tensor:
    """A batch-shaped output gathered from every rank in the global batch's
    row order, and under a spatial mesh with every H-slice of its images;
    ``halves``: each rank's rows are two halves (the adjuster's ``[real
    task, generated task]`` concatenation), kept as two halves."""
    if dg is None:
        return t
    g = dg.gather_rows(t)
    n_data = dg.data_size
    if dg.model_size > 1:  # (data, model, rows, h, ...) -> (data, rows, model * h, ...)
        b, h = t.shape[:2]
        g = g.reshape(n_data, dg.model_size, b, h, *t.shape[2:]).transpose(1, 2)
        g = g.reshape(n_data * b, dg.model_size * h, *t.shape[2:])
    if halves:
        n = t.shape[0] // 2
        g = g.reshape(n_data, 2, n, *g.shape[1:]).transpose(0, 1).reshape(g.shape)
    return g
