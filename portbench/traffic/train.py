"""Traffic kind "train": the system's train step, fed back to back.

Set-up builds the system under test through its entry points
(``models.registry``, ``train.optim.build_optimizer``,
``train.steps.make_train_step`` with on-card augmentation), loads the
benchmark's weights from the seed, puts per-domain uint8 stores on the
card, and runs the first ``compared_steps`` steps through the window's own
call and feed: they warm every shape up, and the check compares them. The
window then issues steps while its seconds last, never waiting for the
device (the indices are drawn on the card), and ends on a synchronize.

The check (after the window, the system's state freed): the plain
reference (``portbench.reference``) takes the same weights, stores and
index rows, draws its dropout and augmentation as the step does, and runs
the same steps; compared are each step's losses, the first gradient's
norm leaf by leaf (read from the system's AdamW state: exp_avg / (1 − β1)
after one update) and the norm of each leaf's change over the compared
steps.
"""
from __future__ import annotations

import time

import torch

from portbench import data, system, weights
from portbench.reference import train as ref_train

def leaf_norms(tensors: dict) -> dict:
    """{name: L2 norm} on the host, one transfer."""
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def worst_leaf(got: dict, want: dict, names) -> float:
    """max over ``names`` of |‖got‖ − ‖want‖| / max(‖want‖, the median
    leaf's ‖want‖)."""
    floor = sorted(want.values())[len(want) // 2]
    return max(abs(got[n] - want[n]) / max(want[n], floor) for n in names)


def compare(prog: dict, ref: dict, excluded_below: float) -> dict:
    """The numbers compared, from two records ``{"losses": [{name: value}]
    a step, "grad": {leaf: norm}, "update": {leaf: norm}}``; the update's
    leaves exclude those whose reference gradient is under
    ``excluded_below`` of the median leaf's (Adam moves them by round-off
    alone)."""
    loss = max(abs(p[k] - r[k]) / abs(r[k]) for p, r in zip(prog["losses"], ref["losses"])
               for k in r)
    g_floor = sorted(ref["grad"].values())[len(ref["grad"]) // 2] * excluded_below
    moved = [n for n, g in ref["grad"].items() if g >= g_floor]
    return {"loss": loss, "grad": worst_leaf(prog["grad"], ref["grad"], ref["grad"]),
            "update": worst_leaf(prog["update"], ref["update"], moved)}


def reference_record(cfg: dict, mix: dict, state: dict, stores, seed: int, device,
                     tf32: bool = False, keep: int | None = None) -> dict:
    """The plain reference's record of the compared steps, in fp32 with
    TF32 off (``tf32``: on, the control); ``keep``: each domain's first
    ``keep`` rows only (a planted fault)."""
    ref_train.set_precision(tf32)
    with torch.device(device):
        model = ref_train.build(cfg)
    model.load_state_dict(state)
    step = ref_train.Step(model, cfg, mix["per_domain_store"] // mix["per_domain_batch"],
                          data.sub_seed(seed, data.STEP))
    epochs = data.Epochs(seed, cfg["num_domains"], mix["per_domain_store"],
                         mix["per_domain_batch"], device)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    record = {"losses": []}
    for k in range(mix["compared_steps"]):
        losses, grads = step(*stores, epochs.next(), keep)
        record["losses"].append(losses)
        if k == 0:
            record["grad"] = leaf_norms(dict(zip((n for n, _ in step.named), grads)))
    record["update"] = leaf_norms({n: p - start[n] for n, p in model.named_parameters()})
    return record


class Traffic:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        self.cfg, self.mix, self.seed, self.device, self.spans = cfg, mix, seed, device, spans
        self.d, self.b = cfg["num_domains"], mix["per_domain_batch"]

    def setup(self) -> None:
        from mdvit_tpu_torch.train.optim import build_optimizer
        from mdvit_tpu_torch.train.steps import make_train_step
        from mdvit_tpu_torch.utils.pieces import DotDict

        cfg, mix, dev = self.cfg, self.mix, self.device
        model = system.build(cfg, dev)
        state = weights.from_seed(cfg, self.seed, dev)
        model.load_state_dict(state)
        self.state = {k: v.cpu() for k, v in state.items()}
        del state
        o = cfg["optimizer"]
        config = DotDict({"train": {"optimizer": {"mode": "adamw", "adamw": {
            "lr": o["lr"], "betas": list(o["betas"]), "eps": o["eps"],
            "weight_decay": o["weight_decay"]}},
            "scheduler": {"step_size": o["step_size"], "gamma": o["gamma"]}}})
        steps_per_epoch = mix["per_domain_store"] // self.b
        optimizer, scheduler = build_optimizer(model, steps_per_epoch, config)
        self.step = make_train_step(model, optimizer, scheduler, self.d, alpha=cfg["alpha"],
                                    det_sup=cfg["det_sup"], mkd=cfg["mkd"],
                                    seed=data.sub_seed(self.seed, data.STEP),
                                    device_augment=True)
        self.stores = data.stores(self.seed, self.d, mix["per_domain_store"], cfg["img_size"], dev)
        self.epochs = data.Epochs(self.seed, self.d, mix["per_domain_store"], self.b, dev)
        named = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        beta1 = o["betas"][0]
        losses = []
        for k in range(mix["compared_steps"]):
            metrics = self.step(*self.stores, self.epochs.next())
            losses.append({n: metrics[n] for n in ("loss", "aux_loss", "kt_loss") if n in metrics})
            if k == 0:
                # the gradient as the optimizer took it (none taken: zero)
                grad = leaf_norms({n: optimizer.state[p]["exp_avg"] / (1 - beta1)
                                   if "exp_avg" in optimizer.state[p] else torch.zeros(())
                                   for n, p in named.items()})
        update = leaf_norms({n: p - start[n] for n, p in named.items()})
        del start
        self.record = {"losses": [{n: float(v) for n, v in s.items()} for s in losses],
                       "grad": grad, "update": update}
        self.model, self.optimizer = model, optimizer
        data.sync(dev)

    def window(self, seconds: float | None = None, steps: int | None = None) -> dict:
        """Steps back to back while ``seconds`` last (or ``steps`` of them);
        the window ends on a synchronize after the last."""
        n = 0
        t0 = time.perf_counter()
        while (n < steps) if steps is not None else (time.perf_counter() - t0 < seconds):
            with self.spans("index"):
                indices = self.epochs.next()
            with self.spans("step"):
                self.step(*self.stores, indices)
            n += 1
        with self.spans("sync"):
            data.sync(self.device)
        return {"work": n, "images": n * self.d * self.b, "seconds": time.perf_counter() - t0}

    def flops(self) -> float:
        from portbench.flops import step_flops
        return step_flops(self.cfg, self.d, self.b, self.cfg["img_size"])

    def release(self) -> None:
        del self.step, self.model, self.optimizer

    def reference(self, tf32: bool = False, keep: int | None = None) -> dict:
        """The reference's record of this run's compared steps."""
        return reference_record(self.cfg, self.mix, self.state, self.stores, self.seed,
                                self.device, tf32, keep)

    def check(self, ref: dict | None = None) -> dict:
        """The compared steps against the reference's (``ref``, or computed)."""
        return compare(self.record, ref or self.reference(), self.mix["excluded_below"])

    @staticmethod
    def end_to_end(result: dict) -> dict:
        return {"train_img_per_s": result["images"] / result["seconds"]}
