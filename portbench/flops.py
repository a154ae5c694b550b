"""The model FLOPs of a step or a serving call, counted by PyTorch's
``FlopCounterMode`` over the plain reference at the cell's shapes, on the
``meta`` device: no device time, no memory. A train step is counted one
domain's block of rows at a time (every block is alike) and multiplied by
the domains: forward, the debranch, both backward pulls. The augmentation
and the optimizer do no matrix work and count nothing."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import train as ref_train
from portbench.reference.model import Model


def _model(cfg: dict) -> Model:
    with torch.device("meta"):
        return ref_train.build(cfg)


def step_flops(cfg: dict, domains: int, per_domain: int, img: int) -> float:
    model = _model(cfg)
    step = ref_train.Step(model, cfg, steps_per_epoch=1, seed=0, augment=False)
    images = tuple(torch.zeros((per_domain, img, img, 3), dtype=torch.uint8, device="meta")
                   for _ in range(domains))
    masks = tuple(torch.zeros((per_domain, img, img), dtype=torch.uint8, device="meta")
                  for _ in range(domains))
    indices = torch.zeros((1, per_domain), dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as counter:
        step.grads(images[:1], masks[:1], indices)
    return float(counter.get_total_flops()) * domains


def serve_flops(cfg: dict, batch: int, img: int) -> float:
    model = _model(cfg)
    images = torch.zeros((batch, img, img, 3), device="meta")
    onehot = torch.zeros((batch, cfg["num_domains"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        ref_train.serve(model, images, onehot, rows=batch)
    return float(counter.get_total_flops())
