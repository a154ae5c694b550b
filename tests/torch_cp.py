"""Rank workers of the port's context-parallel tests
(``test_torch_context_parallel*.py``).

Imports only torch and the port, so the ranks that ``torch_dp.spawn`` starts
never import JAX. Each worker reads its inputs from a ``torch.save``d spec
and writes what it computed to ``<out>/rank<r>.pt``.
"""
import torch
import torch.distributed as dist

from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.parallel.context import (make_context_mesh,
                                              make_context_parallel_train_step,
                                              make_dp_context_mesh,
                                              model_apply_context_parallel,
                                              stage_apply_context_parallel)
from mdvit_tpu_torch.parallel.mesh import halo_exchange_rows
from torch_dp import save


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
    return model


def _mesh(spec: dict):
    if spec.get("grid"):
        return make_dp_context_mesh(*spec["grid"])
    return make_context_mesh()


def e2e_worker(rank: int, spec_path: str, out_dir: str) -> None:
    """On the group of all ranks (or the (data, ctx) grid ``spec["grid"]``):
    the eval forward; with ``spec["train_forward"]``, the train-mode forward
    (the model's dropout, generator seed 7); with ``spec["train"]``, one CP
    train step (``train_step``)."""
    spec = torch.load(spec_path, weights_only=False)
    mesh = _mesh(spec)
    res = forwards(spec, mesh)
    if spec.get("train"):
        res.update(train_step(spec, mesh))
    save(rank, out_dir, res)


def forwards(spec: dict, mesh) -> dict:
    """The eval forward's ``seg`` and ``feat`` and, with
    ``spec["train_forward"]``, the train-mode ``seg``; ``mesh`` None is the
    unsharded model."""
    x, dom, kw = spec["x"], spec["dom"], spec.get("kwargs", {})
    model = _model(spec).eval()
    with torch.no_grad():
        out = model_apply_context_parallel(model, x, dom, mesh, train=False, out_feat=True,
                                           **kw)
        res = {"seg": out["seg"], "feat": out["feat"]}
        if spec.get("train_forward"):
            res["train_seg"] = model_apply_context_parallel(
                model.train(), x, dom, mesh, train=True,
                gen=torch.Generator().manual_seed(7), **kw)["seg"]
    return res


def train_step(spec: dict, mesh) -> dict:
    """One ``make_context_parallel_train_step`` (AdamW 1e-4, wd 0.05) from the
    spec's state; ``mesh`` None is the unsharded step."""
    model = _model(spec).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
    step = make_context_parallel_train_step(model, opt, mesh)
    loss = step(spec["x"], spec["y"], spec["dom"], torch.Generator().manual_seed(9))
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
