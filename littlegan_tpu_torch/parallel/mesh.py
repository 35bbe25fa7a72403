"""Process groups, the port's counterpart of littlegan_tpu/parallel/mesh.py.

The JAX package scales over a ``jax.sharding.Mesh`` with a ``data`` axis and
lets XLA's SPMD partitioner insert the collectives. The port runs one
process per card, as PyTorch programs do: ``torchrun --nproc_per_node N``
starts the processes, :func:`initialize_distributed` joins them into a
``torch.distributed`` process group (NCCL between cards, gloo on the CPU),
and :class:`DataGroup`, the counterpart of a 1-D ``('data',)`` mesh, says
which rank a process is, how many there are and which card it drives.

The collectives the train step needs are methods of :class:`DataGroup`. A
CUDA tensor under gloo goes through host memory, since gloo moves host
buffers; NCCL moves it on the card. Sums are ``SUM`` reductions: the caller
divides by the world size, so gloo and NCCL do the same arithmetic and one
rank gives its input back bit for bit.

Host values (the interrupt flag, the fixture, the restore status) travel on
a second, gloo group (``control``), so that agreeing on them never waits
for the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from littlegan_tpu_torch.utils.device import resolve_device

SPATIAL_TODO = ("ROADMAP A13: spatial mesh (H-sharded convs with a halo exchange) is not ported to "
                "littlegan_tpu_torch yet")


@dataclass(frozen=True)
class DataGroup:
    """One rank of a data-parallel group: ``world`` processes, each training
    ``batch_size / world`` rows of every global batch on ``device``."""

    rank: int
    world: int
    device: torch.device
    group: Any  # the process group of the gradients' collectives
    control: Any  # a gloo group for host values

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


def check_mesh(mesh_axes: Sequence[str], mesh_shape: Optional[Sequence[int]], world: int) -> None:
    """``make_mesh``'s checks on the config's mesh: the port has the 1-D
    data mesh over every rank and nothing else."""
    if tuple(mesh_axes) != ("data",):
        raise NotImplementedError(f"mesh_axes {list(mesh_axes)}: {SPATIAL_TODO}; only ['data'] runs")
    if mesh_shape is not None and list(mesh_shape) != [world]:
        raise NotImplementedError(
            f"mesh_shape {list(mesh_shape)} over {world} rank(s): {SPATIAL_TODO}; the data mesh is [{world}]"
        )


def row_slice(rows: int, dg: Optional[DataGroup]) -> slice:
    """This rank's rows of a global batch of ``rows`` (all of them without a group)."""
    if dg is None:
        return slice(0, rows)
    if rows % dg.world:
        raise ValueError(f"batch of {rows} rows does not split over {dg.world} ranks")
    per = rows // dg.world
    return slice(dg.rank * per, (dg.rank + 1) * per)

