"""Process groups, the port's counterpart of littlegan_tpu/parallel/mesh.py.

The JAX package scales over a ``jax.sharding.Mesh`` with a ``data`` axis (or
``('data', 'model')`` axes) and lets XLA's SPMD partitioner insert the
collectives. The port runs one process per card, as PyTorch programs do:
``torchrun --nproc_per_node N`` starts the processes,
:func:`initialize_distributed` joins them into a ``torch.distributed``
process group (NCCL between cards, gloo on the CPU), and :class:`DataGroup`,
the counterpart of a 1-D ``('data',)`` mesh, says which rank a process is,
how many there are and which card it drives. :class:`SpatialGroup` is the
counterpart of the 2-D ``('data', 'model')`` mesh (``make_mesh``'s row-major
reshape: rank = data index x model size + model index), with a subgroup
along each axis (:func:`spatial_group`).

The collectives the train step needs are methods of :class:`DataGroup`. A
CUDA tensor under gloo goes through host memory, since gloo moves host
buffers; NCCL moves it on the card. Sums are ``SUM`` reductions: the caller
divides by the world size, so gloo and NCCL do the same arithmetic and one
rank gives its input back bit for bit.

Host values (the interrupt flag, the fixture, the restore status) travel on
a second, gloo group (``control``), so that agreeing on them never waits
for the card. Under a spatial mesh the decoded batches travel on a third,
one gloo group per data index (``SpatialGroup.feed``): model rank 0 of a
data index decodes its rows and sends each model rank its H-slice
(:meth:`SpatialGroup.feed_batch`), so that an image is decoded once.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from littlegan_tpu_torch.utils.device import resolve_device

@dataclass(frozen=True)
class DataGroup:
    """One rank of a data-parallel group: ``world`` processes, each training
    ``batch_size / world`` rows of every global batch on ``device``."""

    rank: int
    world: int
    device: torch.device
    group: Any  # the process group of the gradients' collectives
    control: Any  # a gloo group for host values

    # the coordinates of the (data, model) mesh: a 1-D data mesh has one model index
    @property
    def data_rank(self) -> int:
        return self.rank

    @property
    def data_size(self) -> int:
        return self.world

    @property
    def model_rank(self) -> int:
        return 0

    @property
    def model_size(self) -> int:
        return 1

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def staged(self) -> bool:
        """Whether a CUDA tensor's collective goes through host memory (gloo)."""
        return self.device.type == "cuda" and self.backend != "nccl"

    def _run(self, op, out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
        """``op(out, *inputs)`` on this group, through host copies under gloo."""
        if not self.staged:
            op(out, *inputs, group=self.group)
            return out
        host = out.cpu()
        op(host, *(t.cpu() for t in inputs), group=self.group)
        return out.copy_(host)

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        return self._run(dist.all_reduce, t)

    def reduce_scatter_sum(self, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """``out`` (k,) = this rank's k elements of the sum over ranks of ``inp`` (world * k,)."""
        return self._run(dist.reduce_scatter_tensor, out, inp)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """``out`` (world * k,) = every rank's ``inp`` (k,), in rank order."""
        return self._run(dist.all_gather_into_tensor, out, inp)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        return self._run(lambda x, group: dist.broadcast(x, src, group=group), t)

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of rank ``src`` on every rank (pickled, over ``control``)."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src, group=self.control)
        return box[0]

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (one host all-reduce)."""
        t = torch.tensor([float(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item() > 0)

    def all(self, flag: bool) -> bool:
        return not self.any(not flag)

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it (over ``control``)."""
        dist.barrier(group=self.control)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` (the same shape on each rank),
        concatenated in rank order on the leading axis."""
        flat = t.contiguous().reshape(-1)
        out = torch.empty(self.world * flat.numel(), dtype=flat.dtype, device=flat.device)
        return self.all_gather(out, flat).reshape(self.world * t.shape[0], *t.shape[1:])


def initialize_distributed(
    coordinator: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None,
    device=None,
) -> Optional[DataGroup]:
    """Join the process group of ``num_processes`` processes and return this
    rank's :class:`DataGroup`; nothing to do (None) for one process, as the
    JAX package's ``initialize_distributed``. Each argument left out is read
    from what ``torchrun`` sets: ``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR:MASTER_PORT`` (the coordinator, ``host:port``).
    ``device``: the rank's device (default: :func:`resolve_device`'s).
    The backend is NCCL when the rank's device is a card, gloo on the CPU."""
    n = int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None else int(num_processes)
    if n <= 1:
        return None
    rank = int(os.environ.get("RANK", "0")) if process_id is None else int(process_id)
    if coordinator is None:
        coordinator = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ.get('MASTER_PORT', '29500')}"
    if not dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{coordinator}",
                                world_size=n, rank=rank)
    return data_group(device)


def data_group(device=None) -> Optional[DataGroup]:
    """The running default process group as a :class:`DataGroup` on
    ``device`` (default: :func:`resolve_device`'s, the rank's card), or
    None when no group runs.
    Collective: every rank calls it, in the same order as its other group
    calls (it makes the gloo ``control`` group, and under NCCL runs one
    all-reduce, so that the communicator exists before any CUDA graph
    captures a collective)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    dev = resolve_device(device)
    group = dist.group.WORLD
    gloo = dist.get_backend(group) == "gloo"
    control = group if gloo else dist.new_group(backend="gloo")
    dg = DataGroup(dist.get_rank(), dist.get_world_size(), dev, group, control)
    if not gloo:
        dg.all_reduce_sum_(torch.zeros(1, device=dev))
        torch.cuda.synchronize(dev)
    return dg


@dataclass(frozen=True)
class SpatialGroup(DataGroup):
    """One rank of a ``('data', 'model')`` mesh of ``data_size x
    model_size`` ranks: the group's collectives span every rank (the
    gradients'), ``data`` is the subgroup of the ranks holding the same
    H-slice of other rows, ``model`` the subgroup of the ranks holding
    other H-slices of the same rows (the halo exchanges' and the norm
    moments'). A subgroup is a :class:`DataGroup` whose ``rank`` and
    ``world`` are the index and size along its axis; it has no control
    group. ``feed`` is a gloo group of the same ranks as ``model``, for
    the decoded batches on the host (:meth:`feed_batch`): its collectives
    never meet the training group's."""

    data: Optional[DataGroup] = None
    model: Optional[DataGroup] = None
    feed: Any = None

    @property
    def data_rank(self) -> int:
        return self.data.rank

    @property
    def data_size(self) -> int:
        return self.data.world

    @property
    def model_rank(self) -> int:
        return self.model.rank

    @property
    def model_size(self) -> int:
        return self.model.world

    def feed_batch(self, batch: Optional[Tuple[np.ndarray, np.ndarray]]):
        """This rank's part of ``batch`` = (images (rows, H, W, C), conds),
        which model rank 0 of this data index holds (the other model ranks
        pass None): the images' H-slice (a scatter) and the conds whole (a
        broadcast). Model rank 0 passing None ends the feed: every model
        rank gets None. A header of the arrays' shapes and dtypes goes
        first, so the other ranks need not know them. Collective over the
        model ranks of the data index, on ``feed``."""
        src = self.data_rank * self.model_size  # model rank 0's global rank
        header = [None if batch is None else [(a.shape, a.dtype.str) for a in batch]]
        dist.broadcast_object_list(header, src=src, group=self.feed)
        if header[0] is None:
            return None
        (shape, dtype), (cond_shape, cond_dtype) = header[0]
        per = shape[1] // self.model_size
        images = torch.from_numpy(np.empty((shape[0], per, *shape[2:]), dtype))
        chunks = None if batch is None else [torch.from_numpy(np.ascontiguousarray(batch[0][:, m * per:(m + 1) * per]))
                                             for m in range(self.model_size)]
        dist.scatter(images, chunks, src=src, group=self.feed)
        cond = torch.from_numpy(np.empty(cond_shape, cond_dtype) if batch is None else np.ascontiguousarray(batch[1]))
        dist.broadcast(cond, src, group=self.feed)
        return images.numpy(), cond.numpy()


def mesh_shape_of(mesh_shape: Optional[Sequence[int]], world: int) -> Tuple[int, int]:
    """The ``(data, model)`` sizes of a 2-D mesh over ``world`` ranks, as
    ``make_mesh`` sizes it: ``mesh_shape`` when given (its product must be
    the world), else ``(world // 2, 2)`` for an even world."""
    if mesh_shape is None:
        if world % 2:
            raise ValueError(f"pass an explicit shape for a 2-axis mesh over {world} devices")
        return world // 2, 2
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) != 2 or math.prod(shape) != world:
        raise ValueError(f"mesh shape {list(mesh_shape)} != {world} devices")
    return shape


def spatial_group(dg: DataGroup, shape: Optional[Sequence[int]] = None) -> SpatialGroup:
    """``dg`` (every rank) as one rank of a ``(data, model)`` mesh of
    ``shape`` (:func:`mesh_shape_of`'s). Collective: every rank makes every
    subgroup, in the same order (``torch.distributed.new_group``), and
    under NCCL runs one all-reduce on each of its own, so that their
    communicators exist before a CUDA graph captures a collective."""
    n_data, n_model = mesh_shape_of(shape, dg.world)
    di, mi = divmod(dg.rank, n_model)
    backend = dist.get_backend(dg.group)
    model_group = data_group_ = feed = None
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks, backend=backend)
        f = dist.new_group(ranks, backend="gloo")
        if d == di:
            model_group, feed = g, f
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)], backend=backend)
        if m == mi:
            data_group_ = g
    data = DataGroup(di, n_data, dg.device, data_group_, None)
    model = DataGroup(mi, n_model, dg.device, model_group, None)
    if backend == "nccl":
        for sub in (data, model):
            sub.all_reduce_sum_(torch.zeros(1, device=dg.device))
        torch.cuda.synchronize(dg.device)
    return SpatialGroup(dg.rank, dg.world, dg.device, dg.group, dg.control, data, model, feed)


MESH_AXES = (("data",), ("data", "model"))


def check_mesh(mesh_axes: Sequence[str], mesh_shape: Optional[Sequence[int]], world: int) -> None:
    """``make_mesh``'s checks on the config's mesh over ``world`` ranks:
    the axes are ``['data']`` or ``['data', 'model']``; a 1-D mesh's shape,
    when given, is ``[world]``; a 2-D mesh's shape multiplies to the world
    (:func:`mesh_shape_of`). With one rank nothing is built: the JAX trainer
    makes a mesh only over more than one device, so there a
    ``('data', 'model')`` config trains unsharded."""
    if tuple(mesh_axes) not in MESH_AXES:
        raise ValueError(f"mesh_axes {list(mesh_axes)}: the mesh is ['data'] or ['data', 'model']")
    if len(mesh_axes) == 1:
        if mesh_shape is not None and [int(n) for n in mesh_shape] != [world]:
            raise ValueError(f"mesh shape {list(mesh_shape)} != {world} devices")
    elif world > 1:
        mesh_shape_of(mesh_shape, world)


def check_spatial(cfg, shape: Sequence[int]) -> None:
    """``make_spatial_train_step``'s checks (JAX ``spatial.py:45-52``): the
    data axis splits the batch, the model axis the image height."""
    n_data, n_model = shape
    if cfg.batch_size % n_data != 0:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the data-axis size ({n_data})")
    if cfg.image_dim % n_model != 0:
        raise ValueError(f"image_dim {cfg.image_dim} must be divisible by the model-axis size ({n_model})")


def row_slice(rows: int, dg: Optional[DataGroup]) -> slice:
    """This rank's rows of a global batch of ``rows`` (all of them without
    a group): its share along the data axis."""
    if dg is None:
        return slice(0, rows)
    rank, world = getattr(dg, "data_rank", dg.rank), getattr(dg, "data_size", dg.world)
    if rows % world:
        raise ValueError(f"batch of {rows} rows does not split over {world} ranks")
    per = rows // world
    return slice(rank * per, (rank + 1) * per)


def h_slice(height: int, dg: Optional[DataGroup]) -> slice:
    """This rank's rows of an image ``height`` rows high: its share along
    the model axis (all of them without one)."""
    n = 1 if dg is None else dg.model_size
    if n == 1:
        return slice(0, height)
    if height % n:
        raise ValueError(f"height {height} does not split over {n} model ranks")
    per = height // n
    return slice(dg.model_rank * per, (dg.model_rank + 1) * per)
