"""Rank workers of the port's data-parallel tests (``test_torch_dp*.py``).

Imports only torch and the port, so the ranks that
``torch.multiprocessing.spawn`` starts never import JAX. Each rank joins a
gloo group on a ``file://`` store under the test's ``tmp_path`` (no TCP port:
the test files run side by side), runs on one CPU thread and writes what it
computed to ``<out>/rank<r>.pt``.
"""
import contextlib
import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.train.steps import make_train_step

# a spawned group that has not finished by then has hung (a collective
# waiting for a rank that will not come): its processes are killed
DEADLINE_S = 240


def _entry(rank: int, fn, world: int, store: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args) -> list:
    """Run ``fn(rank, *args)`` in ``world`` gloo ranks; returns each rank's
    ``<tmp_path>/out/rank<r>.pt``, loaded."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    store = tmp_path / f"store_{time.monotonic_ns()}"
    ctx = mp.start_processes(_entry, args=(fn, world, str(store), args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def save(rank: int, out_dir, obj) -> None:
    torch.save(obj, os.path.join(out_dir, f"rank{rank}.pt"))


def build(spec: dict) -> torch.nn.Module:
    """The registry model ``spec["model"]`` describes, on the CPU, with
    ``spec["state_dict"]`` loaded and the debranches' dropout at
    ``spec["debranch_drop"]``."""
    model = build_model(**spec["model"], device="cpu")
    model.load_state_dict(spec["state_dict"])
    for m in model.modules():
        if hasattr(m, "dropout_ratio"):
            m.dropout_ratio = spec["debranch_drop"]
    return model


def run_step(spec: dict, group=None) -> dict:
    """One train step (SGD at ``spec["lr"]``) of ``build(spec)`` on
    ``spec["data"]``: metrics, gradients, the state after it, the generator."""
    model = build(spec)
    opt = torch.optim.SGD(model.parameters(), lr=spec["lr"])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    step = make_train_step(model, opt, sched, spec["num_domains"], group=group,
                           **spec["step"])
    images, masks, indices = spec["data"]
    metrics = step(images, masks, indices)
    return {"metrics": metrics, "state": model.state_dict(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "generator": step.generator.get_state()}


def step_worker(rank: int, spec_path: str, out_dir: str) -> None:
    spec = torch.load(spec_path, weights_only=False)
    save(rank, out_dir, run_step(spec, dist.group.WORLD))


def all_reduce_worker(rank: int, out_dir: str) -> None:
    """``all_reduce_sum`` of x_r = (r + 1)·[1, 2, 3] and the gradient of
    Σ c_r·y with c_r = [r + 1, 10, 100] on rank r."""
    from mdvit_tpu_torch.parallel.mesh import all_reduce_sum

    x = (torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)).requires_grad_()
    y = all_reduce_sum(x, dist.group.WORLD)
    (grad,) = torch.autograd.grad((y * torch.tensor([rank + 1.0, 10.0, 100.0])).sum(), x)
    save(rank, out_dir, {"sum": y.detach(), "grad": grad})


def eval_worker(rank: int, overrides: dict, exp_dir: str, out_dir: str) -> None:
    """``Trainer.evaluate("test")`` with the eval split on the device and
    streamed from the host, in the group of all ranks."""
    from mdvit_tpu_torch.config import load_config
    from mdvit_tpu_torch.train.trainer import Trainer

    res = {}
    for device_eval in (True, False):
        over = {**overrides, "tpu": {**overrides["tpu"], "device_eval": device_eval}}
        res[device_eval] = Trainer(load_config(overrides=over), exp_dir).evaluate("test")
    save(rank, out_dir, res)


def cli_worker(rank: int, config_yml: str, exp_dir: str, out_dir: str) -> None:
    """Two CLI runs on ``exp_dir``: one epoch, then resumed to two. Returns
    the Trainer's full state at the end of the first ``fit`` and right after
    the second run's resume, and every file a rank other than 0 opens for
    writing, ``torch.save``s, renames or removes under ``exp_dir``."""
    import builtins
    from unittest import mock

    from mdvit_tpu_torch import cli
    from mdvit_tpu_torch.train.checkpoints import to_host
    from mdvit_tpu_torch.train.trainer import Trainer

    writes, states = [], {}

    def recording(fn, is_write):
        def wrapped(*args, **kw):
            if is_write(*args, **kw) and os.path.abspath(str(args[0])).startswith(exp_dir):
                writes.append((fn.__name__, str(args[0])))
            return fn(*args, **kw)
        return wrapped

    def write_mode(path, mode="r", *a, **kw):
        return any(c in mode for c in "wax+")

    fit, resume = Trainer.fit, Trainer.maybe_resume

    def fit_then_record(self):
        fit(self)
        states["after_fit"] = to_host(self.full_state(self.history[-1]["epoch"]))

    def resume_then_record(self):
        resume(self)
        states["after_resume"] = to_host(self.full_state(self.start_epoch - 1))

    patches = [mock.patch.object(Trainer, "fit", fit_then_record),
               mock.patch.object(Trainer, "maybe_resume", resume_then_record)]
    if rank != 0:
        patches += [mock.patch.object(builtins, "open", recording(builtins.open, write_mode)),
                    mock.patch.object(torch, "save", recording(torch.save, lambda *a: True)),
                    mock.patch.object(os, "replace", recording(os.replace, lambda *a: True)),
                    mock.patch.object(os, "remove", recording(os.remove, lambda *a: True))]
    base = ["--exp_name", "dp", "--model", "MDViT", "--config_yml", config_yml,
            "--exp_dir", exp_dir]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        first = cli.main(base + ["--num_epochs", "1"])
        fitted = states.pop("after_fit")
        second = cli.main(base + ["--num_epochs", "2"])
    save(rank, out_dir, {"writes": writes, "fitted": fitted,
                         "resumed": states["after_resume"],
                         "epochs": (first.start_epoch, second.start_epoch, second.step)})
