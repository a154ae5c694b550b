"""Data parallelism over ``torch.distributed``, the port of
``mdvit_tpu/parallel/mesh.py`` and of the JAX Trainer's mesh rule.

JAX shards the domain-contiguous (D·B) batch over a ``data`` mesh axis and
GSPMD inserts the collectives. Here each rank of the data-parallel group
holds a contiguous slice of the global batch's rows (JAX's ``P("data")`` on
the leading axis) and every coupling across samples is an explicit
collective: the BatchNorms' per-domain sums (``ops/norm.py``), the losses'
per-domain sums (``train/steps.py``), the gradients (one flat buffer after
the backward pulls) and the eval counts. Each rank runs the same ops in the
same order, so the collectives match up.

The step reads its shard from ``current_shard()``, which the train and eval
steps set around their work (``sharded``): the group its sums reduce over,
the global row of the rank's first row and the rows of the global batch.
Dropout and the augmentation hash global row counters from it, so a rank
draws its rows of the masks the unsharded step draws. Outside ``sharded``
the shard is the whole batch on one process and nothing is reduced.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, NamedTuple

import torch
import torch.distributed as dist


def mesh_size(world: int, cap: int, total_batch: int) -> int:
    """Ranks of the data-parallel group (``trainer.py:137-143``): the largest
    divisor of ``total_batch`` (D·B) that is at most ``world`` and ``cap``
    (``tpu.mesh.data``; -1 or 0 means no cap)."""
    n = world if cap in (-1, 0) else min(cap, world)
    while n > 1 and total_batch % n:
        n -= 1
    return max(n, 1)


def init_distributed(device: str | torch.device | None = None, backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> bool:
    """Join the process group: from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
    the arguments. The backend is NCCL for a CUDA ``device`` and gloo for the
    CPU, unless ``backend`` names one. Returns whether a group of more than one
    process exists; a world of one (no torchrun, no arguments) joins nothing."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if rank is None else {"rank": rank, "world_size": world}
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    return True


def local_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda:{LOCAL_RANK}`` for ``cuda`` (or None) under torchrun; a device
    with an index, or the CPU, as named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


class Mesh(NamedTuple):
    """This process's place in the data-parallel group, the first ``size``
    ranks of the world; ``group`` is None at size 1 (no collective, the
    single-process step). A rank ≥ ``size`` takes no part (``member``)."""

    group: Any
    rank: int
    size: int

    @property
    def member(self) -> bool:
        return self.rank < self.size

    def rows(self, total: int) -> tuple[int, int]:
        """(first global row, rows) of this rank's slice of ``total`` rows."""
        per = total // self.size
        return self.rank * per, per

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(cap: int, total_batch: int) -> Mesh:
    """The data-parallel group over the process group's world by
    ``mesh_size``; every rank of the world must call it (``new_group`` is
    collective)."""
    if not dist.is_initialized():
        return Mesh(None, 0, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = mesh_size(world, cap, total_batch)
    if n == 1:
        group = None
    elif n == world:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)))
    return Mesh(group, rank, n)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group's ranks, forward and backward (as ``SyncBatchNorm``
    reduces its statistics): each rank's loss reads the global sum, so the
    gradient of the sum is the sum of the ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, differentiably; ``t`` itself when
    ``group`` is None."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def domain_slices(row0: int, rows: int, num_domains: int, per_domain: int
                  ) -> list[tuple[int, int]]:
    """Where the global rows [row0, row0 + rows) of a domain-contiguous batch
    of ``num_domains`` groups of ``per_domain`` fall: per domain, the
    (start, stop) of those rows within its group, start == stop where there
    are none."""
    out = []
    for d in range(num_domains):
        lo = min(max(row0 - d * per_domain, 0), per_domain)
        out.append((lo, max(lo, min(row0 + rows - d * per_domain, per_domain))))
    return out


class Shard(NamedTuple):
    """A rank's rows of a global batch: ``group`` reduces the batch's sums
    (None: nothing to reduce), ``row0`` is the global row of the rank's first
    row and ``total`` the rows of the global batch (None: the local batch is
    the whole batch)."""

    group: Any = None
    row0: int = 0
    total: int | None = None


_shard = Shard()


@contextlib.contextmanager
def sharded(shard: Shard) -> Iterator[None]:
    """``current_shard()`` is ``shard`` inside."""
    global _shard
    outer, _shard = _shard, shard
    try:
        yield
    finally:
        _shard = outer


def current_shard() -> Shard:
    return _shard
