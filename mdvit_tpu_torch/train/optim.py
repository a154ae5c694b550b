"""Optimizer and staircase StepLR from the config (``mdvit_tpu/train/optim.py``).

``train.optimizer.mode`` picks AdamW (``lr``, ``betas``, ``eps``,
``weight_decay`` of ``train.optimizer.adamw``, decay on all parameters) or
Adam (``train.optimizer.adam.lr``; optax's ``adam`` defaults otherwise, which
are torch's). The learning rate of update k (from 0) is
``lr · gamma^⌊k / (step_size · steps_per_epoch)⌋`` (``train.scheduler``), as
``optax.exponential_decay(staircase=True)`` gives it: the first update takes
the base lr. Call ``scheduler.step()`` once after every ``optimizer.step()``.
"""
from __future__ import annotations

import torch

from mdvit_tpu_torch.config import DEFAULT_CONFIG
from mdvit_tpu_torch.utils.pieces import DotDict


def _settings(config) -> tuple[DotDict, float, int, float]:
    cfg = DotDict(DEFAULT_CONFIG) if config is None else config
    opt = cfg.train.optimizer
    if opt.mode not in ("adamw", "adam"):
        raise ValueError(f"unknown optimizer mode {opt.mode!r}")
    sched = cfg.train.get("scheduler") or {}
    return (opt, float(opt[opt.mode].lr), int(sched.get("step_size", 50)),
            float(sched.get("gamma", 0.5)))


def steplr(config, steps_per_epoch: int, k: int) -> float:
    """The learning rate of update ``k`` (from 0)."""
    _, lr, step_size, gamma = _settings(config)
    return lr * gamma ** (k // (step_size * steps_per_epoch))


def build_optimizer(model: torch.nn.Module, steps_per_epoch: int, config=None,
                    step_size_epochs: int | None = None):
    """(optimizer, scheduler) over all of ``model``'s parameters, from
    ``config`` (``DEFAULT_CONFIG`` when None); ``step_size_epochs`` overrides
    ``train.scheduler.step_size``."""
    opt, lr, step_size, gamma = _settings(config)
    step_size = step_size if step_size_epochs is None else step_size_epochs
    if opt.mode == "adamw":
        a = opt.adamw
        optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                      betas=(float(a.betas[0]), float(a.betas[1])),
                                      eps=float(a.eps), weight_decay=float(a.weight_decay))
    else:
        optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    transition = step_size * steps_per_epoch
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: gamma ** (k // transition))
    return optimizer, scheduler
