"""Segmentation losses (``mdvit_tpu/train/losses.py``), fp32 inside,
global sums over the whole batch as the reference's ``torch.sum``."""
from __future__ import annotations

import torch

_SMOOTH = 1e-5


def dice_loss(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice with squared denominator: 1 − (2·Σpt + s)/(Σp² + Σt² + s)."""
    score, target = score.float(), target.float()
    intersect = (score * target).sum()
    return 1.0 - (2.0 * intersect + _SMOOTH) / (
        (score * score).sum() + (target * target).sum() + _SMOOTH)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean BCE from logits: max(x, 0) − x·t + log1p(exp(−|x|))."""
    x, t = logits.float(), target.float()
    return (x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()
