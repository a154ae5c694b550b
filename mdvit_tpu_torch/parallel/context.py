"""Context (sequence) parallelism over ``torch.distributed``, the port of
``mdvit_tpu/parallel/context.py``.

Each rank of a ctx group holds a block of rows of every token grid, in rank
order. The factorized attention's only couplings across tokens are the
column softmax and KᵀV: kernels A and A′ write per-chunk partials of both
into a workspace, an all-gather of that workspace runs between their two
launches, and every rank's apply folds all ranks' partials in rank order
(``ops/factorized_attention.py``). The depthwise convs of CPE and CRPE
(kernels B–C′) run on the rank's rows plus ``k//2`` halo rows from its
neighbours (``halo_exchange_rows``), with the global top and bottom getting
zeros, as the unsharded grid's zero padding gives them; their weight
gradients are rank-partial sums that the gradient all-reduce adds. The
layers reach those row-shard collectives in ``parallel/mesh.py``; this
module holds the entry points above the models.

Two paths, as in JAX:

* stage level (``stage_apply_context_parallel``): one ``MHSAStage`` with its
  tokens sharded by rows (JAX's ``shard_map`` path). Dropout folds the
  shard index into its seed over local counters; DropPath keeps one
  per-sample mask on every shard.
* end to end (``model_apply_context_parallel``,
  ``make_context_parallel_train_step``): the whole forward of BASE and its
  family, MDViT with each of its four debranches, the segmentation
  comparators (UTNet, SwinUnet, SwinUNETR; the TransFuse family forward
  only) and (forward only) the MPViT, CoaT-Lite and CoaT classifiers, with
  the image rows sharded (JAX's GSPMD path). The convs exchange ``(k−1)//2``
  halo rows and pad only W (non-overlapping patch embeds need none), the
  BatchNorms sum their moments over every rank of the grid (InstanceNorm
  over the ctx group), resizes take the input rows their output rows need
  as a halo, spatial means are summed over the ctx group, and dropout
  hashes the unsharded step's counters, so the masks are the unsharded
  masks' rows. CoaT's cls row of each scale lives on ctx rank 0 (its
  attention partials count it once); the head reads it there
  (``from_first``). The comparators' couplings across rows: TransFuse's
  DeiT attends its queries over every rank's keys and values, UTNet reduces
  its keys and values from the whole grid (a sum of the ranks' products
  with their columns of the resize matrix), and a Swin block takes the rows
  of its windows that other ranks hold (cyclically, for the shift); each
  such gather's backward sums the ranks' gradients.

The (data, ctx) grid (``make_dp_context_mesh``) composes both: rank r sits
at (r // n_ctx, r % n_ctx); its ctx group is its grid row, its data group
its column, and the batch's sums (BN moments, loss terms, gradients) run
over the whole grid.

Any height JAX's guards accept: a model lists its chain of row-changing
ops (``row_chain``: SAME-padded stride-s convs, ⌈R/s⌉ rows, or
non-overlapping s-windows, ⌊R/s⌋), and ``row_split`` builds every grid's
split from the input H. Rank r < n − 1 holds t·u_r rows of a grid whose
stride to the deepest grid is t, the last rank the rest, so every rank
boundary is a multiple of each op's stride: a strided conv's window never
needs a row its halo does not bring, and no tiled window spans two ranks.
The deepest shares u make the largest block of input rows as small as it
can be (ties to the most even deepest split, then to the first ranks):
BASE at 100² over 2 ranks splits its grids 100, 50, 25, 13, 7, 4 as
64 : 36, 32 : 18, 16 : 9, 8 : 5, 4 : 3, 2 : 2. At H a multiple of the
stride to the deepest grid this is ``balanced_rows`` of that grid scaled.
Decoder grids, MDViT's H/4 debranch grid and the final resize to H take
the split of the encoder grid of the same height. The gathers pad blocks
to the largest and trim; A's and A′'s workspaces pad to the most chunks
any rank holds, with empty partials. A model without a chain (UTNet and
TransFuse, whose deepest grids are H/16, ``row_split_stride``; SwinUnet,
SwinUNETR, H/32) runs at H a multiple of that stride: off it (100², say)
its forward, as JAX's, has no form, and the port refuses with a
``ValueError`` before any collective. JAX's guard itself reads
``total_stride`` (32 where a model sets none, as the comparators do), and
so does the port's.

Refused, as JAX's fail: ``swin_tiny``'s forward (JAX passes the domain
one-hot positionally, onto ``SwinClassifier``'s ``train``) and TransFuse's
train step (its three deep-supervision maps; JAX's step casts the tuple).
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, NamedTuple

import torch
import torch.distributed as dist

from mdvit_tpu_torch.device import deterministic, no_tf32
from mdvit_tpu_torch.models.base import split_seg
from mdvit_tpu_torch.parallel.mesh import (RowShard, Shard, all_reduce, all_reduce_sum,
                                           collective, gather_rows, row_sharded, row_split,
                                           sharded)
from mdvit_tpu_torch.train.losses import seg_loss_from_sums, seg_loss_sums
from mdvit_tpu_torch.utils.spans import span

# total stem + patch-embed downsampling to the deepest (bridge) grid of
# BASE and MDViT: the stem /4, three strided embeds /2 each
BASE_TOTAL_STRIDE = 32


# ---------------------------------------------------------------- meshes


class ContextMesh(NamedTuple):
    """This rank's place in a (data, ctx) grid of ``n_data · n_ctx`` ranks:
    ``ctx`` the group of its grid row (the ranks that split one batch's
    rows), ``data`` that of its column, ``grid`` all the grid's ranks (the
    batch's sums); ``dp`` whether the grid has a data axis (JAX's mesh with
    a ``"data"`` axis name)."""

    ctx: Any
    data: Any
    grid: Any
    ctx_index: int
    data_index: int
    n_ctx: int
    n_data: int
    dp: bool = False


def _new_group(ranks: list[int], world: int) -> Any:
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def make_dp_context_mesh(n_data: int, n_ctx: int) -> ContextMesh:
    """A 2-D (data, ctx) grid over the first ``n_data · n_ctx`` ranks: the
    batch split over ``data``, the image rows over ``ctx``. Every rank of the
    world must call it (``new_group`` is collective): it makes the group of
    every row, then of every column, then the grid's, in that order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    need = n_data * n_ctx
    if need > world:
        raise ValueError(f"requested a {n_data}x{n_ctx} mesh but only {world} ranks "
                         "are in the process group")
    rows = [_new_group([d * n_ctx + c for c in range(n_ctx)], world) for d in range(n_data)]
    cols = [_new_group([d * n_ctx + c for d in range(n_data)], world) for c in range(n_ctx)]
    grid = _new_group(list(range(need)), world)
    if rank >= need:
        raise ValueError(f"rank {rank} is outside the {n_data}x{n_ctx} grid")
    d, c = divmod(rank, n_ctx)
    return ContextMesh(rows[d], cols[c], grid, c, d, n_ctx, n_data, dp=True)


def make_context_mesh(n: int | None = None) -> ContextMesh:
    """A 1-D mesh over the rows: the first ``n`` ranks (all, when None) split
    every grid's rows; no data axis."""
    n = dist.get_world_size() if n is None else n
    mesh = make_dp_context_mesh(1, n)
    return mesh._replace(dp=False)


def _as_mesh(group: Any) -> ContextMesh:
    """A ``ContextMesh`` as it is; a process group as a 1-D mesh over it;
    None as no mesh (one process, nothing sharded)."""
    if isinstance(group, ContextMesh):
        return group
    if group is None:
        return ContextMesh(None, None, None, 0, 0, 1, 1)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return ContextMesh(group, None, group, i, 0, n, 1)


# ---------------------------------------------------------------- stage level


def stage_apply_context_parallel(stage, x: torch.Tensor, size, group: Any,
                                 domain_onehot: torch.Tensor | None = None,
                                 train: bool = False,
                                 gen: torch.Generator | None = None) -> torch.Tensor:
    """Run an ``MHSAStage`` with its (B, H·W, C) tokens row-sharded over
    ``group``: each rank runs its H/n rows of ``x`` (the whole token tensor,
    the same on every rank) and the result is the whole (B, H·W, C) output,
    gathered (differentiable; each rank's gradient flows back through its own
    rows). The parameters are the unsharded stage's, so one checkpoint
    serves both layouts."""
    h, w = size
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if h % n:
        raise ValueError(f"grid height {h} not divisible by {n} shards")
    b, ntok, c = x.shape
    if ntok != h * w:
        raise ValueError(f"{ntok} tokens are not a {h}x{w} grid")
    h_loc = h // n
    tokens = x.reshape(b, h, w, c)[:, idx * h_loc:(idx + 1) * h_loc].reshape(b, h_loc * w, c)
    with row_sharded(RowShard(group, idx, n, "stage")):
        out = stage(tokens, (h_loc, w), domain_onehot, train, gen)
    return gather_rows(out.reshape(b, h_loc, w, c), group).reshape(b, ntok, c)


# ---------------------------------------------------------------- end to end


def _check_model(model) -> None:
    """Raise unless ``model`` runs row-sharded. A model says so itself: its
    ``context_parallel_gap`` names what keeps it out (None: nothing; BASE and
    its family, MDViT, the segmentation comparators, MPViT, CoaT), and a
    model without the attribute has no row-sharded form."""
    gap = getattr(model, "context_parallel_gap", type(model).__name__)
    if gap is not None:
        raise NotImplementedError(
            f"no context parallelism for {gap} (BASE, its family, MDViT, UTNet, SwinUnet, "
            "SwinUNETR, the TransFuse family, MPViT, CoaT-Lite and CoaT have it)")


def _split_stride(model) -> int:
    """The stride from the input to the deepest grid of a model without a
    ``row_chain`` (``row_split_stride``; else the guard's stride)."""
    return getattr(model, "row_split_stride", getattr(model, "total_stride", BASE_TOTAL_STRIDE))


def _check_min_grid(model, shape, mesh: ContextMesh) -> None:
    """JAX's two guards, with their words and its stride (``total_stride``,
    32 where the model sets none); then, for a model without a
    ``row_chain``, its own height rule (H a multiple of ``_split_stride``),
    where its forward, as JAX's, has no form at another H."""
    n_ctx = mesh.n_ctx
    stride = getattr(model, "total_stride", BASE_TOTAL_STRIDE)
    min_grid = shape[1] // stride
    if min_grid < n_ctx:
        raise ValueError(
            f"context parallelism needs every sharded grid dim >= the ctx axis ({n_ctx}); "
            f"input H={shape[1]} reaches a {min_grid}x{min_grid} deepest grid (total "
            f"stride {stride}); use img_size >= {stride * n_ctx} or a smaller ctx axis")
    if mesh.dp:
        n_data = mesh.n_data
        if shape[0] % n_data:
            raise ValueError(f"batch {shape[0]} not divisible by the data axis ({n_data})")
        if (shape[0] // n_data) * (min_grid // n_ctx) < 2:
            raise ValueError(
                f"DP x CP composed mesh needs >= 2 samples-or-rows per shard at the "
                f"deepest grid: batch/data = {shape[0] // n_data}, grid/ctx = "
                f"{min_grid // n_ctx} (JAX's SPMD miscompiles the 1x1-tile case; the "
                "port keeps its guard). Grow the batch, the image, or shrink the mesh.")
    unit = _split_stride(model)
    if getattr(model, "row_chain", None) is None and shape[1] % unit:
        raise ValueError(
            f"{type(model).__name__} runs at H a multiple of {unit} only, the stride to its "
            f"deepest grid: its forward (as JAX's) has no form at input H={shape[1]}")


@contextlib.contextmanager
def _e2e(model, mesh: ContextMesh, shape) -> Iterator[tuple[int, int, RowShard | None]]:
    """The end-to-end shard of a global (B, H, W, ...) input of ``shape``:
    the batch's sums over the grid, this rank's batch rows, and its image
    rows, every grid's split over the ctx ranks by ``row_split`` from the
    model's ``row_chain``. Yields (first batch row, batch rows, the row
    shard; None without a ctx group)."""
    per = shape[0] // mesh.n_data
    row0 = mesh.data_index * per
    grid = mesh.grid if mesh.n_ctx * mesh.n_data > 1 else None
    rows = None
    if mesh.ctx is not None:
        units, grids = row_split(shape[1], shape[2], mesh.n_ctx,
                                 getattr(model, "row_chain", None), _split_stride(model))
        rows = RowShard(mesh.ctx, mesh.ctx_index, mesh.n_ctx, "e2e", units, grids)
    with sharded(Shard(grid, row0, shape[0])), row_sharded(rows):
        yield row0, per, rows


def _local(t: torch.Tensor, rows: RowShard | None, row0: int, per: int) -> torch.Tensor:
    """This rank's batch rows and image rows of a global (B, H, ...) tensor."""
    t = t[row0:row0 + per]
    if rows is None:
        return t
    h = rows.local_rows(t.shape[1])
    start = rows.start(h)
    return t[:, start:start + h]


def _gather_out(t: torch.Tensor, mesh: ContextMesh, rows: RowShard | None) -> torch.Tensor:
    if mesh.n_ctx > 1:
        t = gather_rows(t, mesh.ctx, dim=1, sizes=rows.split(t.shape[1]))
    return _gather_batch(t, mesh)


def _gather_batch(t: torch.Tensor, mesh: ContextMesh) -> torch.Tensor:
    return gather_rows(t, mesh.data if mesh.n_data > 1 else None, dim=0)


def model_apply_context_parallel(model, x: torch.Tensor, domain_onehot: torch.Tensor | None,
                                 group: Any, train: bool = False,
                                 gen: torch.Generator | None = None, **kwargs) -> dict:
    """The whole model's forward with the image rows (and, on a DP×CP grid,
    the batch) of the global (B, H, W, 3) ``x`` sharded over ``group`` (a
    process group: a 1-D ctx mesh; or a ``ContextMesh``). Every rank passes
    the same ``x``; the outputs are gathered, the same on every rank:
    ``seg`` (B, H, W, 1) (MDViT: the (logits, aux) pair; TransFuse: its three
    maps), ``feat`` and, for the classifiers, ``logits``."""
    mesh = _as_mesh(group)
    _check_model(model)
    _check_min_grid(model, x.shape, mesh)
    with _e2e(model, mesh, x.shape) as (row0, per, rows):
        onehot = None if domain_onehot is None else domain_onehot[row0:row0 + per]
        out = model(_local(x, rows, row0, per), onehot, train=train, gen=gen, **kwargs)
    res = dict(out)
    seg = out.get("seg")
    if isinstance(seg, tuple):
        res["seg"] = tuple(None if s is None else _gather_out(s, mesh, rows) for s in seg)
    elif seg is not None:
        res["seg"] = _gather_out(seg, mesh, rows)
    for key in ("feat", "logits"):
        if out.get(key) is not None:
            res[key] = _gather_batch(out[key], mesh)
    return res


def make_context_parallel_train_step(model, optimizer, group: Any):
    """``step(x, y, onehot, gen) → loss``: one single-loss (BASE-family,
    UTNet, SwinUnet, SwinUNETR) train step with the image rows of the global
    batch sharded over ``group`` (a
    process group or a ``ContextMesh``), every rank passing the same global
    (B, H, W, 3) ``x``, (B, H, W, 1) ``y`` and (B, D) one-hot, and a CPU
    generator in the same state. The loss is BCE + squared-denominator dice
    from the logits (``seg_loss_from_logits``), formed from its terms summed
    over the grid; one backward pull; the gradients are summed over the grid
    in one flat buffer (each rank's pull holds the gradient through its rows,
    scaled by the grid's size: the sums' backward adds the ranks' identical
    upstream gradients) and divided by its size; then ``optimizer.step()``.
    The BatchNorms' running stats take the grid's moments, the same on every
    rank. Returns the loss, the same on every rank. While a profiler records,
    the step is the span ``mdvit.train_step`` around ``mdvit.forward`` (the
    model call and the loss's sums), ``mdvit.backward`` (the pull) and
    ``mdvit.optimizer`` (the gradient all-reduce, the gradients set, the
    optimizer's step), as the single-card step's; each collective inside is
    a ``mdvit.cp.*`` span (``parallel/mesh.py``). A model whose
    ``context_parallel_step_gap`` names a reason (TransFuse) is refused."""
    mesh = _as_mesh(group)
    _check_model(model)
    gap = getattr(model, "context_parallel_step_gap", None)
    if gap is not None:
        raise NotImplementedError(f"no context-parallel train step for {gap}")
    params = list(model.parameters())
    size = mesh.n_ctx * mesh.n_data

    @no_tf32()
    @deterministic()
    def step(x: torch.Tensor, y: torch.Tensor, onehot: torch.Tensor,
             gen: torch.Generator | None = None) -> torch.Tensor:
        _check_min_grid(model, x.shape, mesh)
        with span("mdvit.train_step"):
            with _e2e(model, mesh, x.shape) as (row0, per, rows), span("mdvit.forward"):
                out = model(_local(x, rows, row0, per), onehot[row0:row0 + per], train=True,
                            gen=gen)
                logits = split_seg(out["seg"])[0]
                sums = seg_loss_sums(logits, _local(y, rows, row0, per))
                loss = seg_loss_from_sums(all_reduce_sum(sums, mesh.grid if size > 1 else None))
            with span("mdvit.backward"):
                grads = torch.autograd.grad(loss, params, allow_unused=True,
                                            materialize_grads=True)
            with span("mdvit.optimizer"):
                if size > 1:
                    with collective("reduce"):
                        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh.grid)
                        grads = [part.view_as(g) for part, g in
                                 zip(flat.div_(size).split([g.numel() for g in grads]), grads)]
                for p, g in zip(params, grads):
                    p.grad = g
                optimizer.step()
            return loss.detach()

    return step
