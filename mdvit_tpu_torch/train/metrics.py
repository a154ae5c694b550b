"""Segmentation metrics on the device (``mdvit_tpu/train/metrics.py``),
medpy parity on a whole batch array: global (not per-image) binary overlap;
``dc`` is 0 when both masks are empty, ``jc`` 0 when the union is empty."""
from __future__ import annotations

import torch


def _counts(pred: torch.Tensor, target: torch.Tensor):
    pred, target = pred.float(), target.float()
    return (pred * target).sum(), pred.sum(), target.sum()


def dice_coef(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary Dice over the whole array (medpy ``dc``)."""
    inter, sp, st = _counts(pred, target)
    denom = sp + st
    return torch.where(denom > 0, 2.0 * inter / denom.clamp(min=1.0), 0.0)


def jaccard(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary Jaccard / IoU over the whole array (medpy ``jc``)."""
    inter, sp, st = _counts(pred, target)
    union = sp + st - inter
    return torch.where(union > 0, inter / union.clamp(min=1.0), 0.0)


def dice_per_image(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image dice over a batch (B, ...) → (B,) (reference
    ``Utils/pieces.dice_per_img``)."""
    b = pred.shape[0]
    p, t = pred.reshape(b, -1).float(), target.reshape(b, -1).float()
    inter = (p * t).sum(1)
    denom = p.sum(1) + t.sum(1)
    return torch.where(denom > 0, 2.0 * inter / denom.clamp(min=1.0), 0.0)


def seg_metrics(probs: torch.Tensor, target: torch.Tensor, threshold: float = 0.5):
    """Dice and IoU of thresholded probabilities, as a dict of 0-d tensors."""
    pred = (probs > threshold).float()
    return {"dice": dice_coef(pred, target), "iou": jaccard(pred, target)}
