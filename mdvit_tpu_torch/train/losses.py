"""Segmentation losses (``mdvit_tpu/train/losses.py``), fp32, in the terms
and sums they are formed from: the train and eval steps sum the terms over a
group's values (and, under data parallelism, over the ranks) before they
form a loss, so a group split across ranks gets the whole group's loss.
TransFuse's ``structure_loss`` is a mean of per-image terms, so its sums are
over images.

The whole-array losses of the JAX module (``dice_loss``,
``dice_loss_nonsquared``, ``iou_loss``, ``bce_loss`` with torch's log clamp
at −100, ``bce_with_logits``, ``seg_loss_from_logits``, ``entropy_loss``)
are here too, as global sums over every value; ``seg_loss_from_logits`` is
formed from ``seg_loss_sums``, which a context-parallel step sums over its
ranks before ``seg_loss_from_sums`` forms the loss."""
from __future__ import annotations

import math

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


def dice_loss(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice with squared denominator over the whole array:
    1 − (2·Σpt + s)/(Σp² + Σt² + s)."""
    p, t = score.float(), target.float()
    return dice_loss_from_sums((p * t).sum(), (p * p).sum(), (t * t).sum())


def dice_loss_nonsquared(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Dice with a non-squared denominator (the reference's ``dice_loss1``)."""
    p, t = score.float(), target.float()
    return 1.0 - (2.0 * (p * t).sum() + _SMOOTH) / (p.sum() + t.sum() + _SMOOTH)


def iou_loss(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft IoU loss: 1 − (Σpt + s)/(Σp² + Σt² − Σpt + s)."""
    p, t = score.float(), target.float()
    inter = (p * t).sum()
    union = (p * p).sum() + (t * t).sum() - inter
    return 1.0 - (inter + _SMOOTH) / (union + _SMOOTH)


def bce_loss(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean BCE on probabilities with ``nn.BCELoss``'s log clamp at −100."""
    p, t = probs.float(), target.float()
    log_p = torch.log(p).clamp(min=-100.0)
    log_1p = torch.log1p(-p).clamp(min=-100.0)
    return -(t * log_p + (1.0 - t) * log_1p).mean()


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean BCE from logits, the mean of ``bce_terms``."""
    return bce_terms(logits, target).mean()


def seg_loss_sums(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(Σbce, Σpt, Σp², Σt², count) of BCE + dice from logits, fp32, (5,):
    the terms ``seg_loss_from_sums`` forms the loss of, summable over ranks
    that each hold part of the array."""
    x, t = logits.float(), target.float()
    p = torch.sigmoid(x)
    return torch.stack([bce_terms(x, t).sum(), (p * t).sum(), (p * p).sum(), (t * t).sum(),
                        torch.tensor(float(t.numel()), device=t.device)])


def seg_loss_from_sums(sums: torch.Tensor) -> torch.Tensor:
    """BCE mean + squared-denominator dice from ``seg_loss_sums``."""
    bce, pt, pp, tt, n = sums.unbind(0)
    return bce / n + dice_loss_from_sums(pt, pp, tt)


def seg_loss_from_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE + squared-denominator dice, the reference's training criterion
    (``[nn.BCELoss(), dice_loss]`` on sigmoided outputs), from logits."""
    return seg_loss_from_sums(seg_loss_sums(logits, target))


def entropy_loss(probs: torch.Tensor, c: int = 2) -> torch.Tensor:
    """Mean entropy of binary probabilities over log(c)."""
    p = probs.float()
    ent = -(p * torch.log(p + 1e-6) + (1.0 - p) * torch.log(1.0 - p + 1e-6))
    return ent.mean() / math.log(float(c))


def structure_weights(mask: torch.Tensor) -> torch.Tensor:
    """TransFuse's boundary weights 1 + 5·|avgpool31(mask) − mask| of a
    (B, H, W, 1) mask, fp32: a 31×31 mean, stride 1, padding 15 counted as
    zeros (``F.avg_pool2d``'s ``count_include_pad``, JAX's reduce_window sum
    over 961)."""
    m = mask.float()
    pooled = torch.nn.functional.avg_pool2d(m.permute(0, 3, 1, 2), 31, 1, 15)
    return 1.0 + 5.0 * (pooled.permute(0, 2, 3, 1) - m).abs()


def structure_terms(logits: torch.Tensor, mask: torch.Tensor,
                    weit: torch.Tensor | None = None) -> torch.Tensor:
    """Each image's weighted BCE-with-logits plus weighted IoU, (B,), fp32;
    ``weit`` the mask's ``structure_weights`` (made here when None)."""
    x, m = logits.float(), mask.float()
    weit = structure_weights(m) if weit is None else weit
    dims = (1, 2, 3)
    wbce = (weit * bce_terms(x, m)).sum(dim=dims) / weit.sum(dim=dims)
    pred = torch.sigmoid(x)
    inter = (pred * m * weit).sum(dim=dims)
    union = ((pred + m) * weit).sum(dim=dims)
    return wbce + 1.0 - (inter + 1.0) / (union - inter + 1.0)


def structure_loss(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """TransFuse's deep-supervision loss (``losses.py:structure_loss``): the
    batch mean of ``structure_terms``; NHWC (B, H, W, 1) logits and mask."""
    return structure_terms(logits, mask).mean()
