"""Rank workers of the port's context-parallel tests
(``test_torch_context_parallel*.py``).

Imports only torch and the port, so the ranks that ``torch_dp.spawn`` starts
never import JAX. Each worker reads its inputs from a ``torch.save``d spec
and writes what it computed to ``<out>/rank<r>.pt``. A spec with ``"fp64"``
runs in fp64 (``fp64``): the ranks against one process then differ by fp64
rounding alone, where fp32's other orders of the same sums can move a value
near a kink (ReLU, max pool) or a logit near zero past a tolerance, by
amounts that depend on the CPU's vector width.
"""
import contextlib
from unittest import mock

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mdvit_tpu_torch.models.base import FATEncoderDecoder
from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.models.coat import CoaT
from mdvit_tpu_torch.models.mpvit import MPViT
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops import layers
from mdvit_tpu_torch.ops import resize as resize_module
from mdvit_tpu_torch.ops.layers import Conv2d
from mdvit_tpu_torch.ops.resize import (local_size, resize_ac_whole, resize_bilinear,
                                        resize_bilinear_align_corners)
from mdvit_tpu_torch.parallel.context import (make_context_mesh,
                                              make_context_parallel_train_step,
                                              make_dp_context_mesh,
                                              model_apply_context_parallel,
                                              stage_apply_context_parallel)
from mdvit_tpu_torch.parallel.mesh import (RowShard, cyclic_rows, from_first,
                                           gather_rows, gather_shared_rows,
                                           halo_exchange_rows, halo_rows, row_sharded,
                                           row_split, spatial_mean, spatial_moments)
from torch_dp import save


# the ranks' fp64 results against one process's, relative L2 (chip_smoke.py's
# CP_FP64_GRAD_TOL): fp64 rounding through the step reaches ~1e-13
FP64_L2_TOL = 1e-9


@contextlib.contextmanager
def fp64():
    """Every default dtype, fp32 cast (``Tensor.float``: the norms', the
    moments', the losses') and resize constant in fp64 (``chip_smoke.py``'s
    ``_step_grads_fp64``)."""
    constant = resize_module.device_constant
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(torch.Tensor, "float", lambda t: t.to(torch.float64)), \
                mock.patch.object(resize_module, "device_constant",
                                  lambda *a: constant(*a).double()):
            yield
    finally:
        torch.set_default_dtype(default)


def rel_l2(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over every tensor of two dicts of one set of names."""
    num = sum(float((got[n].double() - w.double()).square().sum()) for n, w in want.items())
    return (num / sum(float(w.double().square().sum()) for w in want.values())) ** 0.5


def padded_workspace(blocks, tokens, ch: int, grad: bool, where: str) -> torch.Tensor:
    """The gathered workspace of ranks holding ``tokens`` rows each: every
    rank's (BH, S_r·P) partials ``blocks`` padded to the most chunks any rank
    holds with empty partials (``pad_partials``), ``where`` "last" or
    "first" in the rank's block, concatenated a (b, h) in rank order (what
    the all-gather gives); "none" concatenates them unpadded."""
    if where == "none":
        return torch.cat(blocks, 1)
    most = max(-(-t // fa.chunk_rows(ch, grad)) for t in tokens)
    p = fa.partial_floats(ch, grad)
    out = []
    for ws in blocks:
        padded = fa.pad_partials(ws, most, ch, grad)
        if where == "first":
            own = ws.shape[1] // p
            b3 = padded.reshape(ws.shape[0], most, p)
            padded = torch.cat([b3[:, own:], b3[:, :own]], 1).reshape(ws.shape[0], -1)
        out.append(padded)
    return torch.stack(out, 1).reshape(blocks[0].shape[0], -1)


def halo_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """``halo_exchange_rows`` of this rank's rows of ``full`` and the gradient
    of Σ out·g, g this rank's block of the cotangent."""
    spec = torch.load(spec_path, weights_only=False)
    full, halo, g = spec["full"], spec["halo"], spec["cotangent"]
    h_loc = full.shape[1] // dist.get_world_size()
    x = full[:, rank * h_loc:(rank + 1) * h_loc].clone().requires_grad_()
    out = halo_exchange_rows(x, halo, dist.group.WORLD)
    (dx,) = torch.autograd.grad((out * g[rank]).sum(), x)
    try:
        halo_exchange_rows(x[:, :halo - 1], halo, dist.group.WORLD)
        too_deep = None
    except ValueError as e:
        too_deep = str(e)
    save(rank, out_dir, {"out": out.detach(), "dx": dx, "too_deep": too_deep})


def _stage(spec: dict) -> MHSAStage:
    stage = MHSAStage(**spec["stage"])
    stage.load_state_dict(spec["state_dict"])
    return stage


def stage_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """The stage's CP forward (eval) on the group of all ranks, and the
    gradients of Σ out·g over its parameters, summed over the ranks."""
    spec = torch.load(spec_path, weights_only=False)
    stage = _stage(spec)
    x, dom, g = spec["x"], spec["dom"], spec["cotangent"]
    out = stage_apply_context_parallel(stage, x, spec["size"], dist.group.WORLD, dom)
    names = [n for n, _ in stage.named_parameters()]
    grads = torch.autograd.grad((out * g).sum(), [p for _, p in stage.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    flat = torch.cat([t.reshape(-1) for t in grads])
    dist.all_reduce(flat)
    grads = dict(zip(names, [p.view_as(t) for p, t in
                             zip(flat.split([t.numel() for t in grads]), grads)]))
    save(rank, out_dir, {"out": out.detach(), "grads": grads})


def _model(spec: dict, **over) -> torch.nn.Module:
    model = build_model(**{**spec["model"], **over}, device="cpu")
    model.load_state_dict(spec["state_dict"])
    if spec.get("fp64"):
        model.double()
        for m in model.modules():
            for attr in ("compute_dtype", "dtype"):  # the dtypes a module casts to
                if isinstance(getattr(m, attr, None), torch.dtype):
                    setattr(m, attr, torch.float64)
    return model


def _inputs(spec: dict, *keys: str) -> list:
    """The spec's tensors ``keys``, in fp64 for an fp64 spec."""
    return [spec[k].double() if spec.get("fp64") else spec[k] for k in keys]


def _precision(spec: dict):
    return fp64() if spec.get("fp64") else contextlib.nullcontext()


def _mesh(spec: dict):
    if spec.get("grid"):
        return make_dp_context_mesh(*spec["grid"])
    return make_context_mesh()


def e2e_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """On the group of all ranks (or the (data, ctx) grid ``spec["grid"]``):
    the eval forward; with ``spec["train_forward"]``, the train-mode forward
    (the model's dropout, generator seed 7); with ``spec["train"]``, one CP
    train step (``train_step``); with ``spec["train_no_drop"]``, one more
    from the same state with dropout and stochastic depth off (under
    ``"no_drop"``); with ``spec["fp64_too"]``, the eval and train-mode
    forwards and the train step once more in fp64 (under ``"fp64"``)."""
    spec = torch.load(spec_path, weights_only=False)
    mesh = _mesh(spec)
    res = forwards(spec, mesh)
    if spec.get("train"):
        res.update(train_step(spec, mesh))
    if spec.get("train_no_drop"):
        res["no_drop"] = train_step(spec, mesh, drop_rate=0.0, drop_path_rate=0.0)
    if spec.get("fp64_too"):
        res["fp64"] = fp64_forward_and_step(spec, mesh)
    save(rank, out_dir, res)


def fp64_forward_and_step(spec: dict, mesh) -> dict:
    """``forwards`` with the train-mode forward and ``train_step``, in fp64."""
    spec = dict(spec, fp64=True, train_forward=True)
    return {**forwards(spec, mesh), **train_step(spec, mesh)}


def forwards(spec: dict, mesh) -> dict:
    """The eval forward's ``seg`` and ``feat`` and, with
    ``spec["train_forward"]``, the train-mode ``seg``; ``mesh`` None is the
    unsharded model."""
    (x, dom), kw = _inputs(spec, "x", "dom"), spec.get("kwargs", {})
    model = _model(spec).eval()
    with torch.no_grad(), _precision(spec):
        out = model_apply_context_parallel(model, x, dom, mesh, train=False, out_feat=True,
                                           **kw)
        res = {"seg": out["seg"], "feat": out["feat"]}
        if spec.get("train_forward"):
            res["train_seg"] = model_apply_context_parallel(
                model.train(), x, dom, mesh, train=True,
                gen=torch.Generator().manual_seed(7), **kw)["seg"]
    return res


def train_step(spec: dict, mesh, **over) -> dict:
    """One ``make_context_parallel_train_step`` (AdamW 1e-4, wd 0.05) from the
    spec's state (the model's arguments ``over`` changed); ``mesh`` None is
    the unsharded step."""
    model = _model(spec, **over).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
    step = make_context_parallel_train_step(model, opt, mesh)
    with _precision(spec):
        loss = step(*_inputs(spec, "x", "y", "dom"), torch.Generator().manual_seed(9))
    return {"loss": loss, "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers() if "running" in n}}


def guard_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """The ``ValueError`` messages of the min-grid guard (all ranks on one
    ctx axis) and, on a (2, 2) grid, of the 1×1-tile guard."""
    spec = torch.load(spec_path, weights_only=False)
    model = _model(spec).eval()
    msgs = {}
    for name, mesh, batch in (("min_grid", make_context_mesh(), 1),
                              ("tile", make_dp_context_mesh(2, 2), 2)):
        x = torch.zeros(batch, 64, 64, 3)
        dom = torch.eye(4)[:batch]
        try:
            model_apply_context_parallel(model, x, dom, mesh)
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)
    save(rank, out_dir, msgs)


def blocks_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """This rank's block (``spec["rows"]`` of the deepest grid, scaled by
    ``spec["level"]``) of ``spec["full"]`` through the row-shard pieces in
    ``"e2e"`` mode: halos of 1 row (the neighbours') and of ``spec["deep"]``
    rows (past them), the gather, the spatial mean, a resize to half and to
    twice the rows, a stride-2 3×3 conv, rank 0's first row on every rank
    (``from_first``; also with NaN in the other ranks' rows) and an element
    dropout mask; and the gradient of Σ out·g of each, g this rank's
    cotangent."""
    spec = torch.load(spec_path, weights_only=False)
    n = dist.get_world_size()
    ctx = RowShard(dist.group.WORLD, rank, n, "e2e", spec["rows"])
    full, cot = spec["full"], spec["cotangents"][rank]
    h = ctx.local_rows(full.shape[1])
    start = ctx.start(h)
    x = full[:, start:start + h].clone().requires_grad_()
    conv = Conv2d(full.shape[3], 4, 3, 2, 1)
    conv.load_state_dict(spec["conv"])
    res = {"start": start, "split": ctx.split(h)}
    with row_sharded(ctx):
        outs = {"halo1": halo_rows(x, 1, ctx), "halo_deep": halo_rows(x, spec["deep"], ctx),
                "gather": gather_rows(x, ctx.group, sizes=ctx.split(h)),
                "mean": spatial_mean(x),
                "down": resize_bilinear(x, local_size((full.shape[1] // 2, full.shape[2]))),
                "up": resize_bilinear(x, local_size((full.shape[1] * 2, full.shape[2]))),
                "conv": conv(x), "first": from_first(x[:, 0])}
        with torch.no_grad():
            res["first_poisoned"] = from_first(x[:, 0] if rank == 0 else
                                               torch.full_like(x[:, 0], float("nan")))
        with mock.patch.object(layers, "draw_seed", lambda gen: spec["seed"]):
            res["mask"] = layers.fast_dropout(torch.ones_like(x), 0.5, True, None) != 0
    for name, out in outs.items():
        (dx,) = torch.autograd.grad((out * cot[name]).sum(), x)
        res[name] = out.detach()
        res[f"d_{name}"] = dx
    save(rank, out_dir, res)


CLASSIFIERS = {"mpvit": MPViT, "coat": CoaT}


def classifier_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """A classifier's eval forward with the image rows over the group of all
    ranks, and the gradients of the mean cross-entropy of its logits against
    ``spec["labels"]``, summed over the ranks and divided by their count."""
    spec = torch.load(spec_path, weights_only=False)
    model = CLASSIFIERS[spec["cls"]](**spec["kw"]).eval()
    model.load_state_dict(spec["state_dict"])
    out = model_apply_context_parallel(model, spec["x"], None, make_context_mesh())
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(F.cross_entropy(out["logits"], spec["labels"]),
                                list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    flat = torch.cat([t.reshape(-1) for t in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    save(rank, out_dir, {"logits": out["logits"].detach(), "feat": out["feat"].detach(),
                         "grads": dict(zip(names, [p.view_as(t) for p, t in zip(
                             flat.split([t.numel() for t in grads]), grads)]))})


def zoo_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """For each case of ``spec["cases"]`` (a spec of ``e2e_worker``'s kind)
    on the group of all ranks: ``forwards`` and, with ``case["train"]``,
    ``train_step``."""
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_context_mesh()
    res = {}
    for cid, case in spec["cases"].items():
        res[cid] = forwards(case, mesh)
        if case.get("train"):
            res[cid].update(train_step(case, mesh))
    save(rank, out_dir, res)


def zoo_blocks_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """This rank's block (``spec["rows"]`` of the deepest grid, scaled by
    ``spec["level"]``) of ``spec["full"]`` through the comparators'
    row-shard pieces in ``"e2e"`` mode: ``cyclic_rows`` of each range set in
    ``spec["ranges"]``, ``gather_shared_rows``, ``spatial_moments``, the
    align-corners resize on row blocks (×2 and to ``spec["head"]`` rows),
    ``resize_ac_whole`` to ``spec["reduce"]`` rows and to the grid's own
    height (an identity row matrix), and an element dropout mask with the
    rows on axis 2; with the
    gradient of Σ out·g of each, g this rank's cotangent."""
    spec = torch.load(spec_path, weights_only=False)
    n = dist.get_world_size()
    ctx = RowShard(dist.group.WORLD, rank, n, "e2e", spec["rows"])
    full, cot = spec["full"], spec["cotangents"][rank]
    h = ctx.local_rows(full.shape[1])
    start = ctx.start(h)
    x = full[:, start:start + h].clone().requires_grad_()
    rs, hw = spec["reduce"], full.shape[1:3]
    res = {}
    with row_sharded(ctx):
        outs = {f"cyclic_{name}": cyclic_rows(x, ranges, ctx)
                for name, ranges in spec["ranges"].items()}
        outs.update({
            "shared": gather_shared_rows(x, ctx),
            "moments": torch.cat(spatial_moments(x), -1),
            "ac_up": resize_bilinear_align_corners(x, local_size((2 * hw[0], hw[1]))),
            "ac_head": resize_bilinear_align_corners(x, local_size((spec["head"], hw[1]))),
            "ac_whole": resize_ac_whole(x, (rs, rs)),
            "ac_whole_same": resize_ac_whole(x, (hw[0], rs))})
        with mock.patch.object(layers, "draw_seed", lambda gen: spec["seed"]):
            tokens = torch.ones(full.shape[0], 3, h * full.shape[2], 5)
            res["mask"] = layers.fast_dropout(tokens, 0.5, True, None, row_axis=2) != 0
    for name, out in outs.items():
        (dx,) = torch.autograd.grad((out * cot[name]).sum(), x)
        res[name] = out.detach()
        res[f"d_{name}"] = dx
    save(rank, out_dir, res)


def ragged_blocks_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """This rank's rows of BASE's grids at ``spec["img"]``² (``row_split`` of
    the trunk's chain over the group of all ranks; ``spec["grids"]``: height
    → the whole (B, R, R, C) grid) through the row-shard pieces in ``"e2e"``
    mode: the SAME stride-2 3×3 conv from ``spec["conv_in"]`` rows, a 3-row
    halo of the deepest grid, the resizes along ``spec["resizes"]`` (each
    from its grid to the next), and element dropout masks of the conv
    input's rows and of its row-major tokens; with the gradient of Σ out·g
    of each, g this rank's cotangent; and every grid's split and start."""
    spec = torch.load(spec_path, weights_only=False)
    n, img = dist.get_world_size(), spec["img"]
    ctx = RowShard(dist.group.WORLD, rank, n, "e2e",
                   *row_split(img, img, n, FATEncoderDecoder.row_chain, 32))
    cot = spec["cotangents"][rank]
    x = {}
    for height, full in spec["grids"].items():
        h = ctx.local_rows(height)
        start = ctx.start(h)
        x[height] = full[:, start:start + h].clone().requires_grad_()
    conv = Conv2d(spec["grids"][spec["conv_in"]].shape[3], 4, 3, 2, 1)
    conv.load_state_dict(spec["conv"])
    deep = min(spec["grids"])
    res = {"split": {height: ctx.split(t.shape[1]) for height, t in x.items()},
           "start": {height: ctx.start(t.shape[1]) for height, t in x.items()}}
    outs = {}
    with row_sharded(ctx):
        outs["conv"] = (spec["conv_in"], conv(x[spec["conv_in"]]))
        outs["halo3"] = (deep, halo_rows(x[deep], 3, ctx))
        for lo, hi in zip(spec["resizes"], spec["resizes"][1:]):
            outs[f"resize_{lo}_{hi}"] = (lo, resize_bilinear(x[lo], local_size((hi, hi))))
        src = x[spec["conv_in"]]
        with mock.patch.object(layers, "draw_seed", lambda gen: spec["seed"]):
            res["mask_rows"] = layers.fast_dropout(torch.ones_like(src), 0.5, True, None) != 0
            res["mask_tokens"] = layers.fast_dropout(
                torch.ones_like(src).flatten(1, 2), 0.5, True, None) != 0
    for name, (height, out) in outs.items():
        (dx,) = torch.autograd.grad((out * cot[name]).sum(), x[height])
        res[name] = out.detach()
        res[f"d_{name}"] = dx
    save(rank, out_dir, res)


def spans_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """The context-parallel step of ``spec["cfg"]``'s BASE over the group of
    all ranks on the global batch that ``spec["indices"]`` selects from
    ``spec["stores"]``, gathered and augmented as the benchmark's ranks do,
    twice from ``spec["state"]``: once with no profiler (counting the port's
    ``record_function`` entries) and once under ``torch.profiler`` (its
    spans and collectives, their threads and times). Each: the loss, the
    gradients, the parameters after the step and ``COLLECTIVES``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdvit_tpu_torch.data.augment import augment_batch
    from mdvit_tpu_torch.data.loader import gather_batch
    from mdvit_tpu_torch.parallel import mesh as mesh_module
    from mdvit_tpu_torch.utils import spans
    from portbench import system

    spec = torch.load(spec_path, weights_only=False)
    cfg, seed = spec["cfg"], spec["seed"]
    o = cfg["optimizer"]
    mesh = make_context_mesh()
    res = {}
    for mode in ("plain", "profiled"):
        model = system.build(cfg, "cpu")
        model.load_state_dict(spec["state"])
        opt = torch.optim.AdamW(model.parameters(), lr=o["lr"], betas=tuple(o["betas"]),
                                eps=o["eps"], weight_decay=o["weight_decay"])
        step = make_context_parallel_train_step(model, opt, mesh)
        x, m, onehot = gather_batch(*spec["stores"], spec["indices"])
        x, y = augment_batch(torch.Generator().manual_seed(seed), x, m)
        gen = torch.Generator().manual_seed(seed)
        mesh_module.reset_collectives()
        entered = []
        if mode == "plain":
            with mock.patch.object(spans, "record_function",
                                   lambda name: entered.append(name)):
                loss = step(x, y, onehot, gen)
            out = {"entered": entered}
        else:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                loss = step(x, y, onehot, gen)
            out = {"events": [(e.name, e.thread, e.time_range.start, e.time_range.end)
                              for e in prof.events() if e.device_type == DeviceType.CPU
                              and (e.name.startswith("mdvit.") or e.name.startswith("c10d::"))]}
        res[mode] = {**out, "loss": loss,
                     "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                     "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                     "collectives": {k: dict(v) for k, v in mesh_module.COLLECTIVES.items()}}
    save(rank, out_dir, res)
