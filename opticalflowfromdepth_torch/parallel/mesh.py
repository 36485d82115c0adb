"""Process groups for data and sequence parallelism (port of
``opticalflowfromdepth_tpu/parallel/mesh.py``).

The JAX package builds one (data, model) device mesh over every chip and
lets XLA insert the collectives. Here each card is one process
(``torch.distributed``):

* :func:`init_distributed` is the rendezvous, from the variables
  ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``), as the JAX one reads
  ``JAX_COORDINATOR_ADDRESS`` and its siblings; without them it does
  nothing. NCCL for CUDA, gloo for the CPU; each process takes
  ``cuda:LOCAL_RANK``.
* :func:`make_mesh` splits the world into model groups of
  ``model_parallel`` consecutive ranks (the rows of the JAX mesh's
  reshape); the ranks that share a model rank (its columns) form the
  data axis. :class:`ProcessMesh` holds this process's model group and
  its data rank and data world, which the loader shards the batch by
  (the JAX ``batch_sharding`` / ``shard_batch``: every process of a
  model group reads the same batch).
* :func:`all_reduce_mean_` is the gradient mean of data parallelism, and
  :func:`all_reduce_sum` a differentiable sum (the batch norm's whole-batch
  statistics). Both reduce over the world: the data axis needs no group
  of its own, because a model group's ranks hold the same values, so the
  world's mean is the data axis's.

A model group may also be a ``parallel.sequence.LocalRing``: the ranks
of a ring run in turn in one process (``ProcessMesh.local``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .sequence import LocalRing, group_size

ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(device="cuda") -> torch.device:
    """Joins the process group the environment describes and returns this
    process's device: ``cuda:LOCAL_RANK`` (NCCL) for ``device="cuda"``,
    the CPU (gloo) for ``device="cpu"``. Without ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``, or when the group is up
    already, it joins nothing and returns ``device`` resolved."""
    device = resolve_device(device)
    if dist.is_initialized() or not all(k in os.environ for k in ENV):
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://",
                            device_id=device if device.type == "cuda"
                            else None)
    return device


@dataclass(frozen=True)
class ProcessMesh:
    """This process's place in the (data, model) layout: its global rank
    and the world, the data rank and world (which batch it reads), the
    model rank, and the model group (a process group or a ``LocalRing``;
    None where it is this process alone).
    ``distributed``: made over an initialized process group, so the train
    steps take their gradients' and metrics' means over the world (also
    at a world of one)."""
    distributed: bool = False
    rank: int = 0
    world: int = 1
    data_rank: int = 0
    data_world: int = 1
    model_rank: int = 0
    model_group: object = None

    @property
    def model_parallel(self) -> int:
        return group_size(self.model_group)

    @classmethod
    def local(cls, model_parallel: int) -> "ProcessMesh":
        """One process that runs a model group of ``model_parallel`` ranks
        in turn (a ``LocalRing``)."""
        return cls(model_group=LocalRing(model_parallel))


def make_mesh(model_parallel: int = 1) -> ProcessMesh:
    """The (data, model) layout of the initialized world: model groups of
    ``model_parallel`` consecutive ranks, the data axis across them
    (``world % model_parallel == 0``, as the JAX mesh asserts). Without a process group the world is this process alone, so
    ``model_parallel > 1`` raises: a ring of several ranks in one process
    is asked for by name (``ProcessMesh.local``). Every rank must call it,
    in the same order (``new_group`` is collective)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if not dist.is_initialized():
        if model_parallel > 1:
            raise ValueError(
                f"model_parallel={model_parallel} needs an initialized "
                "process group of a multiple of that many ranks "
                "(init_distributed), or ProcessMesh.local(n) for a ring "
                "run in turn in this process")
        return ProcessMesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError(f"the world of {world} processes is not a multiple "
                         f"of model_parallel={model_parallel}")
    data_world = world // model_parallel
    model_groups = [_new_group(range(d * model_parallel,
                                     (d + 1) * model_parallel))
                    for d in range(data_world)]
    data_rank, model_rank = divmod(rank, model_parallel)
    return ProcessMesh(distributed=True, rank=rank, world=world,
                       data_rank=data_rank, data_world=data_world,
                       model_rank=model_rank,
                       model_group=model_groups[data_rank])


def _new_group(ranks: Sequence[int]) -> Optional[dist.ProcessGroup]:
    """A process group of ``ranks`` (None for one rank). Called by every
    rank for every group, as ``new_group`` requires."""
    ranks = list(ranks)
    group = dist.new_group(ranks)
    return group if len(ranks) > 1 else None


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Replaces each tensor by its mean over the world, in place, with one
    all-reduce of their concatenation (the data axis's mean; it also keeps
    a model group's ranks identical where a kernel is not deterministic).
    With one process it leaves every bit as it was."""
    if not tensors or not dist.is_initialized():
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its gradient is the sum of the ranks'
    gradients (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks (the world by default),
    differentiable."""
    return _AllReduceSum.apply(x, group)
