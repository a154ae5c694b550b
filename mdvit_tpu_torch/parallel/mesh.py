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

Context parallelism (``parallel/context.py``) shards the rows of the token
grids instead: ``current_context()`` is the ``RowShard`` that
``row_sharded`` sets, read by the layers that couple rows (the depthwise
convs' halos, the factorized attention's softmax and KᵀV, dropout's
counters, spatial means, resizes and convs in the end-to-end path). The
row-shard collectives those layers call live here too: the halo exchange
(``halo_exchange_rows``, ``halo_rows``), ``gather_rows``, ``spatial_mean``
and ``from_first`` (CoaT's cls rows, held by ctx rank 0); for the
segmentation comparators, ``gather_shared_rows`` (the whole on every rank
for a use that differs by rank, its backward a sum over the ranks),
``cyclic_rows`` (a shifted window's rows from whichever ranks hold them,
wrapping from the last row to the first) and ``spatial_moments``
(InstanceNorm's). The ranks' blocks may differ in height (``row_split``,
``RowShard.split``): the gathers pad every block to the largest and trim.

Each collective of the row shards, of A's and A′'s workspace gather
(``ops/factorized_attention.gather_partials``), of the batch's sums
(``all_reduce_sum``) and of the context-parallel step's gradients is issued
in one span of its kind (``utils.spans``), with the copies that feed and
unpack it, forward and backward: ``mdvit.cp.halo`` (``_HaloRows``, ``_HaloFromGrid``),
``mdvit.cp.gather`` (the row and workspace all-gathers, ``_FromFirst``'s
broadcast) and ``mdvit.cp.reduce`` (every all-reduce). ``COLLECTIVES``
counts the calls of each kind and the bytes this rank passes to them.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Iterator, NamedTuple, Sequence

import torch
import torch.distributed as dist

from mdvit_tpu_torch.utils.spans import span

# calls and bytes passed by this rank, by kind; each kind's span is
# ``mdvit.cp.<kind>``
COLLECTIVES = {kind: {"calls": 0, "bytes": 0} for kind in ("halo", "gather", "reduce")}


def reset_collectives() -> None:
    for count in COLLECTIVES.values():
        count.update(calls=0, bytes=0)


_SPANS = {kind: f"mdvit.cp.{kind}" for kind in COLLECTIVES}


def collective(kind: str):
    """The span ``mdvit.cp.<kind>`` of one collective: its call and the
    copies that feed and unpack it are issued inside."""
    return span(_SPANS[kind])


def counted(kind: str, payload: torch.Tensor) -> torch.Tensor:
    """Count one collective call of ``kind`` to which this rank passes
    ``payload``; returns ``payload``."""
    count = COLLECTIVES[kind]
    count["calls"] += 1
    count["bytes"] += payload.numel() * payload.element_size()
    return payload


def all_reduce(t: torch.Tensor, group: Any, kind: str = "reduce") -> torch.Tensor:
    """``t`` summed in place over ``group``'s ranks (counted; the caller
    issues it in its kind's span)."""
    dist.all_reduce(counted(kind, t), group=group)
    return t


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
        with collective("reduce"):
            return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        with collective("reduce"):
            return all_reduce(g.clone(), ctx.group), None


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


class RowShard(NamedTuple):
    """This rank's block of rows of every token grid under context
    parallelism: ``group`` the ctx group, ``index`` the rank's place in it
    (its rows come ``index``-th), ``size`` the group's ranks, ``mode``
    ``"stage"`` (one ``MHSAStage`` sharded; dropout folds ``index`` into its
    seed over local counters, as JAX's ``shard_map`` path does) or ``"e2e"``
    (the whole model; dropout hashes the unsharded masks' global counters).

    ``rows`` is each rank's share of the deepest grid's rows (empty: one
    each, the even split of the stage path). ``grids`` holds every grid of
    the model's chain of row-changing ops at this input (``row_split``), as
    (height, width, every rank's rows): rank r < n − 1 holds t·rows[r] rows
    of a grid whose stride to the deepest grid is t, the last rank the rest,
    so every rank boundary is a multiple of each op's stride. A layer finds
    every rank's rows of a grid from the count it holds (``split``: rows,
    or row-major tokens, ``h·w`` a rank). Without ``grids``, or where every
    grid's split is ``rows`` scaled by its stride (H a multiple of the stride
    to the deepest grid), a grid off the table splits as ``rows`` scaled."""

    group: Any
    index: int
    size: int
    mode: str = "stage"
    rows: tuple = ()
    grids: tuple = ()

    @property
    def units(self) -> tuple:
        return self.rows or (1,) * self.size

    @property
    def scaled(self) -> bool:
        """Whether every grid's split is ``units`` scaled (no table is)."""
        units = self.units
        return all(split[r] * units[self.index] == split[self.index] * units[r]
                   for _, _, split in self.grids for r in range(self.size))

    def _scaled(self, extent: int, what: str) -> tuple:
        units = self.units
        level, rem = divmod(extent, units[self.index])
        if rem or level == 0 or not self.scaled:
            raise ValueError(f"{extent} local {what} are no grid of the row split {units} "
                             f"(grids {[g[:2] for g in self.grids]})")
        return tuple(level * u for u in units)

    def split(self, extent: int, tokens: bool = False) -> tuple:
        """Every rank's rows (``tokens``: row-major tokens) of the grid of
        which this rank holds ``extent``, in rank order. Two grids that give
        this rank ``extent`` with different splits raise: no guess."""
        found = {tuple(r * w for r in split) if tokens else split
                 for _, w, split in self.grids
                 if split[self.index] * (w if tokens else 1) == extent}
        if len(found) > 1:
            raise ValueError(f"{extent} local {'tokens' if tokens else 'rows'} fit several "
                             f"grids of the row split: {sorted(found)}")
        if found:
            return found.pop()
        return self._scaled(extent, "tokens" if tokens else "rows")

    def start(self, extent: int, tokens: bool = False) -> int:
        """The global index of this rank's first of its ``extent`` rows
        (``tokens``: tokens)."""
        return sum(self.split(extent, tokens)[:self.index])

    def local_rows(self, total: int) -> int:
        """This rank's rows of a grid of ``total`` rows."""
        for height, _, split in self.grids:
            if height == total:
                return split[self.index]
        units = self.units
        level, rem = divmod(total, sum(units))
        if rem or level == 0 or not self.scaled:
            raise ValueError(f"{total} rows are no grid of the row split {units} "
                             f"(grids {[g[:2] for g in self.grids]})")
        return level * units[self.index]


def balanced_rows(total: int, n: int) -> tuple:
    """``total`` rows over ``n`` ranks as evenly as they go: the first
    ``total % n`` ranks one more."""
    per, extra = divmod(total, n)
    return tuple(per + (r < extra) for r in range(n))


def chain_sizes(size: int, chain: Sequence[tuple[str, int]]) -> list[int]:
    """The extent of every grid of ``chain`` from an input of ``size``: a
    ``("same", s)`` op (a stride-s conv with SAME padding) gives ⌈R/s⌉, a
    ``("tiled", s)`` op (non-overlapping s-windows) ⌊R/s⌋."""
    out = [size]
    for kind, s in chain:
        out.append(-(-out[-1] // s) if kind == "same" else out[-1] // s)
    return out


def _chain_split(heights: Sequence[int], strides: Sequence[int], units: Sequence[int]
                 ) -> list[tuple]:
    """Every grid's split of the deepest split ``units``: t·u_r for r < n − 1,
    the rest on the last rank."""
    out = []
    for height, t in zip(heights, strides):
        first = tuple(t * u for u in units[:-1])
        out.append(first + (height - sum(first),))
    return out


def row_split(h: int, w: int, n: int, chain: Sequence[tuple[str, int]] | None,
              stride: int) -> tuple[tuple, tuple]:
    """(the deepest grid's rows a rank, ``RowShard.grids``) of an h×w input
    over ``n`` ranks. Without a ``chain`` (a model whose grids are H over a
    power of two, run at H a multiple of ``stride``) the deepest H/stride rows
    split by ``balanced_rows`` and there is no table. With one, the last
    rank's share u of the deepest grid is chosen, the others' balanced over
    the rest: the largest block of the input rows as small as it can be;
    ties to the most even deepest split, then to the first ranks. At H a
    multiple of the chain's stride this is ``balanced_rows``. A split that
    leaves a rank no rows of some grid, or the last rank the same rows of two
    grids (a local count would not say which), is not taken."""
    if chain is None:
        return balanced_rows(h // stride, n), ()
    heights, widths = chain_sizes(h, chain), chain_sizes(w, chain)
    strides = [math.prod(s for _, s in chain[i:]) for i in range(len(heights))]
    deep = heights[-1]
    best, best_key = None, None
    for last in range(1, deep - n + 2) if n > 1 else (deep,):
        units = (balanced_rows(deep - last, n - 1) if n > 1 else ()) + (last,)
        splits = _chain_split(heights, strides, units)
        last_rows = [split[-1] for split in splits]
        if min(last_rows) < 1 or len(set(last_rows)) < len(last_rows):
            continue
        key = (max(splits[0]), sorted(units, reverse=True), [-u for u in units])
        if best_key is None or key < best_key:
            best, best_key = units, key
    if best is None:
        raise ValueError(f"no row split of {h} rows over {n} ranks gives every rank rows of "
                         f"every grid {heights}")
    return best, tuple(zip(heights, widths, _chain_split(heights, strides, best)))


_context: RowShard | None = None


@contextlib.contextmanager
def row_sharded(ctx: RowShard | None) -> Iterator[None]:
    """``current_context()`` is ``ctx`` inside (None: no row sharding)."""
    global _context
    outer, _context = _context, ctx
    try:
        yield
    finally:
        _context = outer


def current_context() -> RowShard | None:
    return _context


# ---------------------------------------------------------------- row shards


def _gather(t: torch.Tensor, group: Any, kind: str = "gather") -> list[torch.Tensor]:
    """Every rank's ``t``: one all-gather of ``kind`` (counted; the caller
    issues it in its kind's span)."""
    t = counted(kind, t.contiguous())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def _gather_blocks(t: torch.Tensor, group: Any, sizes: Sequence[int], dim: int = 1,
                   kind: str = "gather") -> list[torch.Tensor]:
    """Every rank's block of ``t`` along ``dim``, ``sizes`` long in rank
    order: padded to the largest, gathered, trimmed."""
    most = max(sizes)
    if most > t.shape[dim]:
        pad = list(t.shape)
        pad[dim] = most - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    return [p.narrow(dim, 0, s) for p, s in zip(_gather(t, group, kind), sizes)]


class _HaloRows(torch.autograd.Function):
    """Forward: each rank's first and last ``halo`` rows to its neighbours
    (one all-gather of every rank's two edges; gloo takes CUDA tensors in
    collectives, not in point-to-point calls). Backward: the gradient of each
    halo row goes back to the rank that owns the row and is added there."""

    @staticmethod
    def forward(ctx, x, halo, group, index, size):
        ctx.halo, ctx.group, ctx.index, ctx.size = halo, group, index, size
        with collective("halo"):
            edges = _gather(torch.stack([x[:, :halo], x[:, -halo:]]), group, "halo")
            zeros = torch.zeros_like(x[:, :halo])
            above = edges[index - 1][1] if index > 0 else zeros
            below = edges[index + 1][0] if index < size - 1 else zeros
            return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        h, i, n = ctx.halo, ctx.index, ctx.size
        with collective("halo"):
            edges = _gather(torch.stack([g[:, :h], g[:, -h:]]), ctx.group, "halo")
            dx = g[:, h:-h].clone()
            if i < n - 1:  # the next rank's rows above it are my last rows
                dx[:, -h:] += edges[i + 1][0]
            if i > 0:      # the previous rank's rows below it are my first rows
                dx[:, :h] += edges[i - 1][1]
            return dx, None, None, None, None


def halo_exchange_rows(x: torch.Tensor, halo: int, group: Any) -> torch.Tensor:
    """This rank's (B, H_loc, W, C) rows of a global grid laid out in rank
    order over ``group`` → (B, H_loc + 2·halo, W, C): ``halo`` rows of the
    neighbours above and below, zeros past the global top and bottom (the
    zero padding a full-grid conv would see). Differentiable."""
    if halo == 0:
        return x
    if x.shape[1] < halo:
        raise ValueError(f"context-parallel halo {halo} exceeds the {x.shape[1]} local "
                         "rows per shard; use fewer shards or taller inputs")
    return _HaloRows.apply(x, halo, group, dist.get_rank(group), dist.get_world_size(group))


class _HaloFromGrid(torch.autograd.Function):
    """``halo`` rows around this rank's block when they reach past its
    neighbours (deep grids of the end-to-end path, fewer rows on some rank
    than the halo): the whole grid gathered (blocks of ``sizes`` rows),
    zero-padded and cut; the backward adds every rank's halo'd gradient into
    the padded grid (one all-reduce) and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, halo, group, index, sizes):
        ctx.halo, ctx.group, ctx.index, ctx.sizes = halo, group, index, sizes
        r0 = sum(sizes[:index])
        with collective("halo"):
            grid = torch.cat(_gather_blocks(x, group, sizes, kind="halo"), dim=1)
            padded = torch.nn.functional.pad(grid, (0, 0, 0, 0, halo, halo))
            return padded[:, r0:r0 + x.shape[1] + 2 * halo].contiguous()

    @staticmethod
    def backward(ctx, g):
        h, sizes = ctx.halo, ctx.sizes
        r0, rows = sum(sizes[:ctx.index]), sizes[ctx.index]
        with collective("halo"):
            full = g.new_zeros((g.shape[0], sum(sizes) + 2 * h) + tuple(g.shape[2:]))
            full[:, r0:r0 + rows + 2 * h] = g
            all_reduce(full, ctx.group, "halo")
            return full[:, h + r0:h + r0 + rows], None, None, None, None


def halo_rows(x: torch.Tensor, halo: int, ctx: RowShard) -> torch.Tensor:
    """``halo_exchange_rows`` over the row shard's group; in ``"e2e"`` mode
    also where the halo reaches past the neighbours (some rank holds fewer
    rows than ``halo``), as GSPMD's halos do in JAX."""
    if halo == 0:
        return x
    if ctx.mode == "e2e":
        sizes = ctx.split(x.shape[1])
        if min(sizes) < halo:
            return _HaloFromGrid.apply(x, halo, ctx.group, ctx.index, sizes)
    return halo_exchange_rows(x, halo, ctx.group)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, concatenated on axis ``dim`` (blocks of ``sizes``
    rows); the backward takes this rank's rows of the gradient (each rank
    holds the same function of the whole, as JAX's replicated output)."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.index, ctx.rows, ctx.dim = dist.get_rank(group), x.shape[dim], dim
        ctx.start = sum(sizes[:ctx.index])
        with collective("gather"):
            return torch.cat(_gather_blocks(x, group, sizes, dim), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.rows), None, None, None


def gather_rows(x: torch.Tensor, group: Any, dim: int = 1,
                sizes: Sequence[int] | None = None) -> torch.Tensor:
    """The whole of a tensor whose axis ``dim`` is split over ``group`` in rank
    order, each rank's block ``sizes`` long (None: all as long as this
    rank's); ``x`` itself without a group."""
    if group is None:
        return x
    if sizes is None:
        sizes = (x.shape[dim],) * dist.get_world_size(group)
    return _GatherRows.apply(x, group, dim, tuple(sizes))


class _GatherShared(torch.autograd.Function):
    """Every rank's rows, concatenated on axis ``dim`` (blocks of ``sizes``
    rows), where each rank uses the whole its own way (its queries' keys and
    values, a window that spans ranks): the backward adds every rank's
    gradient of the whole and keeps this rank's rows (a reduce-scatter, as
    one all-reduce of the whole)."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes, index):
        ctx.group, ctx.dim, ctx.rows = group, dim, x.shape[dim]
        ctx.start = sum(sizes[:index])
        with collective("gather"):
            return torch.cat(_gather_blocks(x, group, sizes, dim), dim=dim)

    @staticmethod
    def backward(ctx, g):
        with collective("reduce"):
            g = all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.rows), None, None, None, None


def gather_shared_rows(x: torch.Tensor, ctx: RowShard, dim: int = 1,
                       tokens: bool = False) -> torch.Tensor:
    """The whole of a tensor whose axis ``dim`` holds this rank's rows (or,
    with ``tokens``, row-major tokens) of the row shard, on every rank, for
    a use that differs from rank to rank: the backward sums the ranks'
    gradients (``_GatherShared``), where ``gather_rows`` keeps this rank's
    own."""
    return _GatherShared.apply(x, ctx.group, dim, ctx.split(x.shape[dim], tokens), ctx.index)


def _cyclic_segments(lo: int, hi: int, total: int) -> list[tuple[int, int, int]]:
    """Rows [lo, hi) of a grid of ``total`` rows taken modulo ``total``, as
    (offset in the range, first grid row, rows) runs."""
    out, p = [], lo
    while p < hi:
        row = p % total
        n = min(hi - p, total - row)
        out.append((p - lo, row, n))
        p += n
    return out


class _CyclicFromNeighbours(torch.autograd.Function):
    """Each rank's rows with ``ups[r]`` rows of the rank before it on top and
    ``downs[r]`` rows of the rank after it below, cyclically (rank 0's rank
    before is the last): one all-gather of every rank's last max(ups) and
    first max(downs) rows. Backward: each borrowed row's gradient goes back
    to its owner (a second all-gather) and is added there."""

    @staticmethod
    def forward(ctx, x, group, index, size, ups, downs):
        up, down = max(ups), max(downs)
        h = x.shape[1]
        ctx.group, ctx.index, ctx.size, ctx.ups, ctx.downs = group, index, size, ups, downs
        with collective("gather"):
            edges = _gather(torch.cat([x.narrow(1, h - up, up), x.narrow(1, 0, down)], 1),
                            group)
            before, after = edges[(index - 1) % size], edges[(index + 1) % size]
            return torch.cat([before.narrow(1, up - ups[index], ups[index]), x,
                              after.narrow(1, up, downs[index])], 1)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.index, ctx.size
        up, down, u, d = max(ctx.ups), max(ctx.downs), ctx.ups[ctx.index], ctx.downs[ctx.index]
        h = g.shape[1] - u - d
        shape = (g.shape[0],) + tuple(g.shape[2:])
        with collective("gather"):
            above = torch.cat([g.new_zeros((shape[0], up - u) + shape[1:]), g.narrow(1, 0, u)],
                              1)
            below = torch.cat([g.narrow(1, u + h, d),
                               g.new_zeros((shape[0], down - d) + shape[1:])], 1)
            edges = _gather(torch.cat([above, below], 1), ctx.group)
            dx = g.narrow(1, u, h).clone()
            dx[:, h - up:] += edges[(i + 1) % n].narrow(1, 0, up)   # my last rows, lent up
            dx[:, :down] += edges[(i - 1) % n].narrow(1, up, down)  # my first rows, lent down
            return dx, None, None, None, None, None


def cyclic_rows(x: torch.Tensor, ranges: Sequence[tuple[int, int]], ctx: RowShard
                ) -> torch.Tensor:
    """This rank's rows [lo, hi) of the global (B, H, ...) grid, modulo H
    (a window range that covers the rank's own rows; a shifted window's
    range wraps past the last row to the first), ``ranges`` every rank's
    (lo, hi) in rank order, the same on every rank. Nothing moves where every
    range is its rank's block; the neighbours' rows where no range reaches
    past them (``_CyclicFromNeighbours``); else the whole grid
    (``gather_shared_rows``), cut. The backward adds each row's gradient, from
    whichever ranks took it, into its owner's."""
    sizes = ctx.split(x.shape[1])
    starts = [sum(sizes[:r]) for r in range(len(sizes))]
    ups = tuple(s - lo for s, (lo, _) in zip(starts, ranges))
    downs = tuple(hi - s - n for s, n, (_, hi) in zip(starts, sizes, ranges))
    if min(ups) < 0 or min(downs) < 0:
        raise ValueError(f"row ranges {ranges} do not cover the blocks of the split {sizes}")
    if max(ups) == 0 and max(downs) == 0:
        return x
    if max(max(ups), max(downs)) <= min(sizes):
        return _CyclicFromNeighbours.apply(x, ctx.group, ctx.index, len(sizes), ups, downs)
    lo, hi = ranges[ctx.index]
    grid = gather_shared_rows(x, ctx)
    runs = _cyclic_segments(lo, hi, sum(sizes))
    return torch.cat([grid.narrow(1, row, n) for _, row, n in runs], 1)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of (B, H, W, C) over H and W; under an end-to-end row shard, over
    the whole grid (the ranks' sums added, divided by the global pixels)."""
    ctx = current_context()
    if ctx is None or ctx.mode != "e2e":
        return x.mean(dim=(1, 2))
    total = sum(ctx.split(x.shape[1])) * x.shape[2]
    return all_reduce_sum(x.float().sum(dim=(1, 2)), ctx.group).div(total).to(x.dtype)


def spatial_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 mean and variance of (B, H, W, C) over H and W, (B, 1, 1, C) each,
    in two passes (the mean, then the mean of (x − mean)²); under an
    end-to-end row shard, over the whole grid (each pass's sums added over
    the ctx group)."""
    xf = x.float()
    ctx = current_context()
    if ctx is None or ctx.mode != "e2e":
        mean = xf.mean(dim=(1, 2), keepdim=True)
        return mean, (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    total = sum(ctx.split(x.shape[1])) * x.shape[2]
    mean = all_reduce_sum(xf.sum(dim=(1, 2), keepdim=True), ctx.group) / total
    var = all_reduce_sum((xf - mean).square().sum(dim=(1, 2), keepdim=True), ctx.group) / total
    return mean, var


class _FromFirst(torch.autograd.Function):
    """Ctx rank 0's tensor on every rank of ``group`` (a broadcast); the
    backward sums the ranks' gradients into rank 0's input and gives the
    others' inputs zeros, so every rank's backward still reaches the
    collectives behind its input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any, index: int) -> torch.Tensor:
        ctx.group, ctx.index = group, index
        with collective("gather"):
            out = counted("gather", x.clone(memory_format=torch.contiguous_format))
            dist.broadcast(out, dist.get_global_rank(group, 0), group=group)
            return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        with collective("reduce"):
            g = all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group)
            return (g if ctx.index == 0 else torch.zeros_like(g)), None, None


def from_first(x: torch.Tensor) -> torch.Tensor:
    """Under an end-to-end row shard, ctx rank 0's ``x`` on every rank, the
    backward summed into rank 0's (``_FromFirst``: the other ranks' values
    never enter it, so a non-finite one there changes nothing). ``x``
    itself otherwise."""
    ctx = current_context()
    if ctx is None or ctx.mode != "e2e" or ctx.group is None:
        return x
    return _FromFirst.apply(x, ctx.group, ctx.index)
