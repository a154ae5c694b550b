"""The 4-domain MDViT train step with the MKD masked double backward
(``mdvit_tpu/train/steps.py:make_train_step``).

The reference's staged backward freezes every parameter whose name contains
``domain_layer`` for the aux loss's backward, then unfreezes them for the
unified loss's. The functional form, as the JAX step has it:

  grad[p] = ∂(L_aux + L_uni)/∂p   for p ∉ domain_layer
  grad[p] = ∂(L_uni)/∂p           for p ∈ domain_layer

One forward, then two backward pulls: ``autograd.grad`` of L_aux + L_uni over
all parameters (keeping the graph), and of L_uni over the ``domain_layer``
parameters alone; the second pull's gradients replace the first's there.
Autograd prunes from the second pull the work no ``domain_layer`` parameter
needs. Losses are summed over domains, each computed on its own domain's
group of the domain-contiguous batch.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from mdvit_tpu_torch.data.loader import eval_transform, gather_batch
from mdvit_tpu_torch.device import no_tf32
from mdvit_tpu_torch.train.losses import bce_with_logits, dice_loss


def _dice_iou(probs: torch.Tensor, y: torch.Tensor):
    """Thresholded (0.5) dice and jaccard of each domain's group, (D, ...)
    → (D,), with the empty-set guards of ``steps.py:_dice_iou``."""
    dims = tuple(range(1, probs.dim()))
    pred = (probs > 0.5).float()
    inter = (pred * y).sum(dim=dims)
    sp, st = pred.sum(dim=dims), y.sum(dim=dims)
    zero = torch.zeros_like(inter)
    dice = torch.where(sp + st > 0, 2 * inter / (sp + st).clamp(min=1), zero)
    union = sp + st - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1), zero)
    return dice, iou


def per_domain_losses(logits: torch.Tensor, aux_logits: torch.Tensor,
                      labels: torch.Tensor, num_domains: int):
    """Per-domain (seg, aux, kt) losses and (dice, iou), each (D,), from the
    domain-contiguous (D·B, H, W, 1) outputs (``steps.py:_per_domain_losses``).
    KT is ``dice_loss(aux_probs, probs)`` with no detach, as in JAX."""
    def group(a):
        return a.float().reshape((num_domains, -1) + tuple(a.shape[1:]))

    lg, ag, yg = group(logits), group(aux_logits), group(labels)
    probs, aux_probs = torch.sigmoid(lg), torch.sigmoid(ag)
    seg, aux, kt = [], [], []
    for d in range(num_domains):
        seg.append(bce_with_logits(lg[d], yg[d]) + dice_loss(probs[d], yg[d]))
        aux.append(bce_with_logits(ag[d], yg[d]) + dice_loss(aux_probs[d], yg[d]))
        kt.append(dice_loss(aux_probs[d], probs[d]))
    dice, iou = _dice_iou(probs, yg)
    return torch.stack(seg), torch.stack(aux), torch.stack(kt), dice, iou


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, num_domains: int, alpha: float = 0.5,
                    det_sup: bool = True, mkd: bool = True, seed: int = 0
                    ) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(images, masks, indices) → metrics``: one train step of ``model``
    on the batch that ``indices`` (D, B) selects from the per-domain uint8
    stores ``images``/``masks``. Dropout and stochastic depth draw from a
    ``torch.Generator`` seeded with ``seed``. Metrics are device tensors with
    the JAX step's names; reading them is the caller's choice. The step runs
    with TF32 off (``no_tf32``), whatever the caller's flags say."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    masked = [i for i, (n, _) in enumerate(named) if "domain_layer" in n]
    gen = torch.Generator().manual_seed(seed)

    def grads_of(loss, wrt, retain=False):
        return torch.autograd.grad(loss, wrt, retain_graph=retain,
                                   allow_unused=True, materialize_grads=True)

    @no_tf32()
    def step(images: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
             indices: torch.Tensor) -> dict[str, torch.Tensor]:
        x_raw, m_raw, onehot = gather_batch(images, masks, indices)
        x, y = eval_transform(x_raw, m_raw)
        out = model(x, onehot, train=True, aux_mode="grouped" if mkd else "none",
                    gen=gen)
        logits, aux_logits = out["seg"]
        if mkd:
            seg_d, aux_d, kt_d, dice_d, iou_d = per_domain_losses(
                logits, aux_logits, y, num_domains)
            multi_seg, multi_aux, multi_kt = seg_d.sum(), aux_d.sum(), kt_d.sum()
            uni = alpha * multi_kt + (1.0 - alpha) * multi_seg
            metrics = {"loss": multi_seg, "aux_loss": multi_aux, "kt_loss": multi_kt,
                       "loss_per_domain": seg_d, "aux_loss_per_domain": aux_d,
                       "kt_loss_per_domain": kt_d}
            grads = list(grads_of(multi_aux + uni, params, retain=det_sup))
            if det_sup:
                g_uni = grads_of(uni, [params[i] for i in masked])
                for i, g in zip(masked, g_uni):
                    grads[i] = g
        else:  # BASE-style single objective
            seg_d, _, _, dice_d, iou_d = per_domain_losses(logits, logits, y, num_domains)
            metrics = {"loss": seg_d.sum(), "loss_per_domain": seg_d}
            grads = grads_of(seg_d.sum(), params)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        scheduler.step()
        metrics.update(dice_per_domain=dice_d, iou_per_domain=iou_d)
        return {k: v.detach() for k, v in metrics.items()}

    return step
