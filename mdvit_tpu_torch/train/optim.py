"""AdamW with a staircase StepLR (``mdvit_tpu/train/optim.py``).

AdamW lr 1e-4, betas (0.9, 0.999), eps 1e-8, weight decay 0.05 on all
parameters. The learning rate of update k (from 0) is
``LR · GAMMA^⌊k / (step_size_epochs · steps_per_epoch)⌋``, as
``optax.exponential_decay(staircase=True)`` gives it: the first update takes
the base lr. Call ``scheduler.step()`` once after every ``optimizer.step()``.
"""
from __future__ import annotations

import torch

LR = 1e-4
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 0.05
GAMMA = 0.5


def build_optimizer(model: torch.nn.Module, steps_per_epoch: int,
                    step_size_epochs: int = 50):
    """(optimizer, scheduler) over all of ``model``'s parameters."""
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS,
                                  weight_decay=WEIGHT_DECAY)
    transition = step_size_epochs * steps_per_epoch
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: GAMMA ** (k // transition))
    return optimizer, scheduler
