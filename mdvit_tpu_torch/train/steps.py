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
needs; a model with no Sup gate has none, and its step makes one pull.
Losses are summed over domains, each computed on its own domain's group of
the domain-contiguous batch. ``mkd=False`` is BASE's single objective, the
sum of the per-domain segmentation losses, in one pull.

The step augments on the device by default (``device_augment``, as in JAX),
drawing from a generator on the model's device (``step.aug_generator``);
dropout draws from a CPU generator (``step.generator``). A checkpoint saves
and restores both.

``remat`` (``tpu.remat``, JAX's ``jax.checkpoint`` around the whole model
forward) runs the model call under a non-reentrant
``torch.utils.checkpoint``: its activations are dropped after the forward
and recomputed in the backward, once a pull (one more forward per pull).
Each recompute replays the forward's dropout seeds (``gen`` restarts from
its state at forward entry, and is left where the recompute found it) and
writes no BatchNorm running stats (``norm.running_stats_frozen``), so the
step's numbers, running stats and generator state are the plain step's.

The eval step (``make_eval_step``) returns masked overlap counts and a
masked fp32 loss of a padded batch. Neither step reads a device value on
the host.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from mdvit_tpu_torch.data.augment import augment_batch
from mdvit_tpu_torch.data.loader import eval_transform, gather_batch
from mdvit_tpu_torch.device import no_tf32
from mdvit_tpu_torch.models.base import split_seg
from mdvit_tpu_torch.ops.norm import running_stats_frozen
from mdvit_tpu_torch.train.losses import _SMOOTH, bce_with_logits, dice_loss


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


class _Recompute:
    """The recompute context of a checkpointed forward, entered once a
    backward pull: ``gen`` replays the forward's draws from ``entry`` and is
    restored on exit, and the norms write no running stats."""

    def __init__(self, gen: torch.Generator, entry: torch.Tensor):
        self.gen, self.entry = gen, entry

    def __enter__(self) -> None:
        self.resume = self.gen.get_state()
        self.gen.set_state(self.entry)
        self.frozen = running_stats_frozen()
        self.frozen.__enter__()

    def __exit__(self, *exc) -> None:
        self.frozen.__exit__(*exc)
        self.gen.set_state(self.resume)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, num_domains: int, alpha: float = 0.5,
                    det_sup: bool = True, mkd: bool = True, seed: int = 0,
                    device_augment: bool = True, remat: bool = False
                    ) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(images, masks, indices) → metrics``: one train step of ``model``
    on the batch that ``indices`` (D, B) selects from the per-domain uint8
    stores ``images``/``masks``, augmented on the device when
    ``device_augment`` (else the eval transform). Dropout and stochastic
    depth draw from a CPU ``torch.Generator`` seeded with ``seed``
    (``step.generator``), the augmentation from one on the model's device
    (``step.aug_generator``, same seed). Metrics are device tensors with the
    JAX step's names; reading them is the caller's choice. The step runs
    with TF32 off (``no_tf32``), whatever the caller's flags say. ``remat``
    recomputes the model's activations in the backward (module docstring)."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    masked = [i for i, (n, _) in enumerate(named) if "domain_layer" in n]
    gen = torch.Generator().manual_seed(seed)
    aug_gen = torch.Generator(device=params[0].device).manual_seed(seed)

    def grads_of(loss, wrt, retain=False):
        return torch.autograd.grad(loss, wrt, retain_graph=retain,
                                   allow_unused=True, materialize_grads=True)

    @no_tf32()
    def step(images: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
             indices: torch.Tensor) -> dict[str, torch.Tensor]:
        x_raw, m_raw, onehot = gather_batch(images, masks, indices)
        if device_augment:
            x, y = augment_batch(aug_gen, x_raw, m_raw)
        else:
            x, y = eval_transform(x_raw, m_raw)

        def forward(x, onehot):
            return model(x, onehot, train=True, aux_mode="grouped" if mkd else "none",
                         gen=gen)

        if remat:
            entry = gen.get_state()
            out = checkpoint(forward, x, onehot, use_reentrant=False,
                             context_fn=lambda: (contextlib.nullcontext(),
                                                 _Recompute(gen, entry)))
        else:
            out = forward(x, onehot)
        logits, aux_logits = split_seg(out["seg"])
        if mkd:
            seg_d, aux_d, kt_d, dice_d, iou_d = per_domain_losses(
                logits, aux_logits, y, num_domains)
            multi_seg, multi_aux, multi_kt = seg_d.sum(), aux_d.sum(), kt_d.sum()
            uni = alpha * multi_kt + (1.0 - alpha) * multi_seg
            metrics = {"loss": multi_seg, "aux_loss": multi_aux, "kt_loss": multi_kt,
                       "loss_per_domain": seg_d, "aux_loss_per_domain": aux_d,
                       "kt_loss_per_domain": kt_d}
            second_pull = det_sup and bool(masked)
            grads = list(grads_of(multi_aux + uni, params, retain=second_pull))
            if second_pull:
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

    step.generator, step.aug_generator = gen, aug_gen
    return step


def _masked_counts(logits: torch.Tensor, y: torch.Tensor,
                   sample_mask: torch.Tensor) -> dict[str, torch.Tensor]:
    probs = torch.sigmoid(logits.float()) * sample_mask
    pred = (probs > 0.5).float()
    yv = y * sample_mask
    return {"inter": (pred * yv).sum(), "sum_pred": pred.sum(), "sum_true": yv.sum()}


def make_eval_step(model: torch.nn.Module, mkd: bool = True, from_store: bool = False
                   ) -> Callable[..., dict]:
    """``step(images, masks, onehot, valid, domain=None, indices=None)`` →
    masked overlap counts and the masked loss of one padded eval batch
    (``mdvit_tpu/train/steps.py:make_eval_step``), so the host can form the
    reference's batch-weighted averages; only the first ``valid`` rows count.

    ``from_store``: ``images``/``masks`` are an ``EvalSplitStore``'s uint8
    tensors and ``indices`` selects the batch on the device. MKD: with
    ``domain`` (a single-domain batch) the model skips the debranches
    (``aux_mode="features"``) and the step applies that domain's debranch;
    without it every debranch runs and the one-hot selects
    (``aux_mode="select"``). The loss (BCE mean + squared-denominator dice)
    is computed in fp32 whatever the model's dtype. Returns device tensors:
    ``{"loss", "primary": {"inter", "sum_pred", "sum_true"}, "aux": …}``."""

    @torch.no_grad()
    @no_tf32()
    def step(images: torch.Tensor, masks: torch.Tensor, onehot: torch.Tensor,
             valid: int, domain: int | None = None,
             indices: torch.Tensor | None = None) -> dict:
        if from_store:
            images, masks = images[indices].float(), masks[indices].float()
        x, y = eval_transform(images, masks)
        aux_mode = "none" if not mkd else ("features" if domain is not None else "select")
        out = model(x, onehot, train=False, aux_mode=aux_mode)
        logits, aux_logits = split_seg(out["seg"])
        if mkd and aux_logits is None:
            aux_logits = model.debranch_module(domain)(out["aux_features"], False)

        b = x.shape[0]
        sample_mask = (torch.arange(b, device=x.device) < valid).float().view(b, 1, 1, 1)
        lg32 = logits.float()
        probs = torch.sigmoid(lg32)
        n_valid = valid * y.shape[1] * y.shape[2] * y.shape[3]
        per_bce = (lg32.clamp(min=0.0) - lg32 * y
                   + torch.log1p(torch.exp(-lg32.abs()))) * sample_mask
        bce = per_bce.sum() / max(n_valid, 1)
        pm, ym = probs * sample_mask, y * sample_mask
        dice_l = 1.0 - (2 * (pm * ym).sum() + _SMOOTH) / (
            (pm * pm).sum() + (ym * ym).sum() + _SMOOTH)
        res = {"loss": bce + dice_l, "primary": _masked_counts(logits, y, sample_mask)}
        if mkd:
            res["aux"] = _masked_counts(aux_logits, y, sample_mask)
        return res

    return step


def counts_to_metrics(c: dict) -> tuple[float, float]:
    """(dice, iou) from one batch's summed counts (host numbers or tensors)."""
    inter, sp, st = float(c["inter"]), float(c["sum_pred"]), float(c["sum_true"])
    dice = 2 * inter / (sp + st) if sp + st > 0 else 0.0
    union = sp + st - inter
    iou = inter / union if union > 0 else 0.0
    return dice, iou
