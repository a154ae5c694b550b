"""Segmentation losses (``mdvit_tpu/train/losses.py``), fp32, in the terms
and sums they are formed from: the train and eval steps sum the terms over a
group's values (and, under data parallelism, over the ranks) before they
form a loss, so a group split across ranks gets the whole group's loss."""
from __future__ import annotations

import torch

_SMOOTH = 1e-5


def bce_terms(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE from logits, fp32: max(x, 0) − x·t + log1p(exp(−|x|));
    ``bce_with_logits`` is their mean."""
    x, t = logits.float(), target.float()
    return x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def dice_loss_from_sums(inter: torch.Tensor, sum_sq_score: torch.Tensor,
                        sum_sq_target: torch.Tensor) -> torch.Tensor:
    """Soft dice with squared denominator, ``dice_loss``, from its sums:
    1 − (2·Σst + s)/(Σs² + Σt² + s)."""
    return 1.0 - (2.0 * inter + _SMOOTH) / (sum_sq_score + sum_sq_target + _SMOOTH)
