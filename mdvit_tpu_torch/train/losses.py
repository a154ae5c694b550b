"""Segmentation losses (``mdvit_tpu/train/losses.py``), fp32, in the terms
and sums they are formed from: the train and eval steps sum the terms over a
group's values (and, under data parallelism, over the ranks) before they
form a loss, so a group split across ranks gets the whole group's loss.
TransFuse's ``structure_loss`` is a mean of per-image terms, so its sums are
over images."""
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
