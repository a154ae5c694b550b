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
sum of the per-domain segmentation losses, in one pull. A model whose
``seg`` is three maps (TransFuse) trains on its deep-supervision loss
(``deep_supervision_losses``), in one pull, whatever ``mkd`` says, as in
JAX; its eval takes map_2.

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

While a profiler records, the train step is the span ``mdvit.train_step``
around ``mdvit.data``, ``mdvit.forward``, one ``mdvit.backward`` a pull and
``mdvit.optimizer`` (``utils.spans``).

The eval step (``make_eval_step``) returns masked overlap counts and a
masked fp32 loss of a padded batch. Neither step reads a device value on
the host. Both run under ``device.deterministic``: two calls from one state
give the same bits.

Data parallelism (``group``, a ``torch.distributed`` group; JAX's
``data_sharding``): each rank takes its contiguous rows of the global batch
(``parallel.mesh``), draws the global batch's augmentation and dropout at
its rows' counters, and every sum across samples is summed over the ranks:
the BatchNorms' moments, the losses' per-domain sums (so a domain split
across ranks gets the unsharded BCE, dice and KT), the eval counts. Every
rank then holds the global losses, and its backward pulls give the
gradient of the global loss through its own rows, scaled by the group's
size (the sums' backward adds the ranks' identical upstream gradients); the
step sums the gradients over the ranks in one flat buffer, divides by the
size and steps the optimizer, so every rank holds the same parameters.
There is no DDP wrapper: DDP's hooks see ``backward()``, not the
``autograd.grad`` pulls of the MKD step. ``group=None`` is the
single-process step, with no collective.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from mdvit_tpu_torch.data.augment import augment_batch
from mdvit_tpu_torch.data.loader import eval_transform, gather_batch
from mdvit_tpu_torch.device import deterministic, no_tf32
from mdvit_tpu_torch.models.base import split_seg
from mdvit_tpu_torch.ops.norm import running_stats_frozen
from mdvit_tpu_torch.parallel.mesh import Shard, all_reduce_sum, current_shard, sharded
from mdvit_tpu_torch.train.losses import (bce_terms, dice_loss_from_sums, structure_terms,
                                          structure_weights)
from mdvit_tpu_torch.utils.spans import span


def _dice_iou(inter, sum_pred, sum_true):
    """Thresholded dice and jaccard from overlap counts, with the empty-set
    guards of ``steps.py:_dice_iou``."""
    zero = torch.zeros_like(inter)
    total = sum_pred + sum_true
    dice = torch.where(total > 0, 2 * inter / total.clamp(min=1), zero)
    union = total - inter
    return dice, torch.where(union > 0, inter / union.clamp(min=1), zero)


def _domain_onehot(shard: Shard, b: int, num_domains: int,
                   device: torch.device) -> torch.Tensor:
    """(b, D) one-hot of the domain of each of this shard's rows of a
    domain-contiguous batch of D equal groups."""
    per = (shard.total or b) // num_domains
    domain = (shard.row0 + torch.arange(b, device=device)) // per
    return (domain[:, None] == torch.arange(num_domains, device=device)).float()


def per_domain_losses(logits: torch.Tensor, aux_logits: torch.Tensor,
                      labels: torch.Tensor, num_domains: int):
    """Per-domain (seg, aux, kt) losses and (dice, iou), each (D,), from the
    (B, H, W, 1) outputs of a domain-contiguous batch of D equal groups, or
    of a rank's rows of one (``parallel.mesh.current_shard``)
    (``steps.py:_per_domain_losses``). Each is formed from its domain's sums
    (Σbce, Σpy, Σp², Σy², ..., the value count), summed over the shard's
    ranks first: the dice of a group is not a sum over its samples. KT is
    ``dice_loss(aux_probs, probs)`` with no detach, as in JAX."""
    shard = current_shard()
    b = logits.shape[0]
    onehot = _domain_onehot(shard, b, num_domains, logits.device)
    lg, ag, y = logits.float(), aux_logits.float(), labels.float()
    p, a = torch.sigmoid(lg), torch.sigmoid(ag)
    pred = (p > 0.5).float()
    terms = (bce_terms(lg, y), p * y, p * p, y * y, bce_terms(ag, y), a * y, a * a, a * p,
             pred * y, pred)
    rows = torch.stack([t.sum(dim=(1, 2, 3)) for t in terms], dim=1)    # (B, K)
    rows = torch.cat([rows, torch.full((b, 1), float(math.prod(y.shape[1:])),
                                       device=rows.device)], dim=1)
    sums = all_reduce_sum(onehot.t() @ rows, shard.group)                # (D, K)
    bce, py, pp, yy, abce, ay, aa, ap, inter, sp, n = sums.unbind(1)
    n = n.clamp(min=1.0)
    seg = bce / n + dice_loss_from_sums(py, pp, yy)
    aux = abce / n + dice_loss_from_sums(ay, aa, yy)
    kt = dice_loss_from_sums(ap, aa, pp)
    return (seg, aux, kt, *_dice_iou(inter, sp, yy))


def deep_supervision_losses(maps: Sequence[torch.Tensor], labels: torch.Tensor,
                            num_domains: int):
    """TransFuse's per-domain loss and (dice, iou), each (D,), from its three
    maps ``(map_x, map_1, map_2)`` (``steps.py:165-190``): per domain
    0.5·L(map_2) + 0.3·L(map_1) + 0.2·L(map_x), L ``structure_loss`` (a
    mean over the domain's images); dice and IoU of σ(map_2). Each is formed
    from per-domain sums over images, summed over the shard's ranks first."""
    shard = current_shard()
    map_x, map_1, map_2 = maps
    b = labels.shape[0]
    onehot = _domain_onehot(shard, b, num_domains, labels.device)
    y = labels.float()
    weit = structure_weights(y)
    pred = (torch.sigmoid(map_2.float()) > 0.5).float()
    dims = (1, 2, 3)
    rows = torch.stack([structure_terms(map_2, y, weit), structure_terms(map_1, y, weit),
                        structure_terms(map_x, y, weit), (pred * y).sum(dim=dims),
                        pred.sum(dim=dims), y.sum(dim=dims),
                        torch.ones(b, device=y.device)], dim=1)            # (B, 7)
    l2, l1, lx, inter, sp, st, n = all_reduce_sum(onehot.t() @ rows, shard.group).unbind(1)
    loss = (0.5 * l2 + 0.3 * l1 + 0.2 * lx) / n.clamp(min=1.0)
    return (loss, *_dice_iou(inter, sp, st))


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


def _rank_and_size(group: Any) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _shard_of(group: Any, total: int) -> Shard:
    """This rank's shard of a ``total``-row batch (the whole, without a group)."""
    rank, size = _rank_and_size(group)
    if total % size:
        raise ValueError(f"a batch of {total} rows does not split over {size} ranks")
    return Shard(group, rank * (total // size), total)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, num_domains: int, alpha: float = 0.5,
                    det_sup: bool = True, mkd: bool = True, seed: int = 0,
                    device_augment: bool = True, remat: bool = False,
                    group: Any = None) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(images, masks, indices) → metrics``: one train step of ``model``
    on the batch that ``indices`` (D, B) selects from the per-domain uint8
    stores ``images``/``masks``, augmented on the device when
    ``device_augment`` (else the eval transform). Dropout and stochastic
    depth draw from a CPU ``torch.Generator`` seeded with ``seed``
    (``step.generator``), the augmentation from one on the model's device
    (``step.aug_generator``, same seed). Metrics are device tensors with the
    JAX step's names; reading them is the caller's choice. The step runs
    with TF32 off (``no_tf32``) and deterministic (``deterministic``),
    whatever the caller's flags say. ``remat`` recomputes the model's
    activations in the backward; ``group`` shards the batch over its ranks
    (module docstring), each rank passing the same global ``indices``."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    masked = [i for i, (n, _) in enumerate(named) if "domain_layer" in n]
    gen = torch.Generator().manual_seed(seed)
    aug_gen = torch.Generator(device=params[0].device).manual_seed(seed)

    def grads_of(loss, wrt, retain=False):
        with span("mdvit.backward"):
            return torch.autograd.grad(loss, wrt, retain_graph=retain,
                                       allow_unused=True, materialize_grads=True)

    size = _rank_and_size(group)[1]

    def pulls(images, masks, indices, shard: Shard):
        """The forward on this rank's rows, the losses and the backward pulls:
        (metrics, gradients)."""
        rows = (shard.row0, shard.total // size)
        with span("mdvit.data"):
            x_raw, m_raw, onehot = gather_batch(images, masks, indices, rows)
            if device_augment:
                x, y = augment_batch(aug_gen, x_raw, m_raw)
            else:
                x, y = eval_transform(x_raw, m_raw)

        def forward(x, onehot):
            return model(x, onehot, train=True, aux_mode="grouped" if mkd else "none",
                         gen=gen)

        with span("mdvit.forward"):
            if remat:
                entry = gen.get_state()
                out = checkpoint(forward, x, onehot, use_reentrant=False,
                                 context_fn=lambda: (contextlib.nullcontext(),
                                                     _Recompute(gen, entry)))
            else:
                out = forward(x, onehot)
        if isinstance(out["seg"], tuple) and len(out["seg"]) == 3:
            # TransFuse's deep supervision: one objective, one pull, no MKD
            loss_d, dice_d, iou_d = deep_supervision_losses(out["seg"], y, num_domains)
            metrics = {"loss": loss_d.sum(), "loss_per_domain": loss_d}
            grads = grads_of(loss_d.sum(), params)
        elif mkd:
            logits, aux_logits = split_seg(out["seg"])
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
            logits = split_seg(out["seg"])[0]
            seg_d, _, _, dice_d, iou_d = per_domain_losses(logits, logits, y, num_domains)
            metrics = {"loss": seg_d.sum(), "loss_per_domain": seg_d}
            grads = grads_of(seg_d.sum(), params)
        metrics.update(dice_per_domain=dice_d, iou_per_domain=iou_d)
        return metrics, list(grads)

    @no_tf32()
    @deterministic()
    def step(images: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
             indices: torch.Tensor) -> dict[str, torch.Tensor]:
        with span("mdvit.train_step"):
            shard = _shard_of(group, indices.numel())
            with sharded(shard):
                metrics, grads = pulls(images, masks, indices, shard)
            with span("mdvit.optimizer"):
                if group is not None:
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    dist.all_reduce(flat, group=group)
                    grads = [part.view_as(g) for part, g in
                             zip(flat.div_(size).split([g.numel() for g in grads]), grads)]
                for p, g in zip(params, grads):
                    p.grad = g
                optimizer.step()
                scheduler.step()
            return {k: v.detach() for k, v in metrics.items()}

    step.generator, step.aug_generator = gen, aug_gen
    return step


def make_eval_step(model: torch.nn.Module, mkd: bool = True, from_store: bool = False,
                   group: Any = None) -> Callable[..., dict]:
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
    is computed in fp32 whatever the model's dtype. ``group``: each rank
    takes its rows of the padded batch (a multiple of the ranks) and the
    sums are summed over the ranks. Returns device tensors:
    ``{"loss", "primary": {"inter", "sum_pred", "sum_true"}, "aux": …}``."""

    size = _rank_and_size(group)[1]

    @torch.no_grad()
    @no_tf32()
    @deterministic()
    def step(images: torch.Tensor, masks: torch.Tensor, onehot: torch.Tensor,
             valid: int, domain: int | None = None,
             indices: torch.Tensor | None = None) -> dict:
        row0 = _shard_of(group, onehot.shape[0]).row0
        b = onehot.shape[0] // size
        rows = slice(row0, row0 + b)
        if from_store:
            idx = indices[rows]
            images, masks = images[idx].float(), masks[idx].float()
        else:
            images, masks = images[rows], masks[rows]
        onehot = onehot[rows]
        x, y = eval_transform(images, masks)
        aux_mode = "none" if not mkd else ("features" if domain is not None else "select")
        out = model(x, onehot, train=False, aux_mode=aux_mode)
        logits, aux_logits = split_seg(out["seg"])
        if mkd and aux_logits is None:
            aux_logits = model.debranch_module(domain)(out["aux_features"], False)

        live = (row0 + torch.arange(b, device=x.device)) < valid
        sample_mask = live.float().view(b, 1, 1, 1)
        lg32 = logits.float()
        pm, ym = torch.sigmoid(lg32) * sample_mask, y * sample_mask
        sums = [(bce_terms(lg32, y) * sample_mask).sum(), (pm * ym).sum(), (pm * pm).sum(),
                (ym * ym).sum(), *_masked_counts(logits, y, sample_mask)]
        if mkd:
            sums += _masked_counts(aux_logits, y, sample_mask)
        sums = torch.stack(sums)
        if group is not None:
            dist.all_reduce(sums, group=group)
        n_valid = valid * y.shape[1] * y.shape[2] * y.shape[3]
        bce = sums[0] / max(n_valid, 1)
        res = {"loss": bce + dice_loss_from_sums(*sums[1:4]),
               "primary": dict(zip(_COUNTS, sums[4:7]))}
        if mkd:
            res["aux"] = dict(zip(_COUNTS, sums[7:10]))
        return res

    return step


_COUNTS = ("inter", "sum_pred", "sum_true")


def _masked_counts(logits: torch.Tensor, y: torch.Tensor,
                   sample_mask: torch.Tensor) -> list[torch.Tensor]:
    """Σ pred·y, Σ pred, Σ y over the rows ``sample_mask`` keeps."""
    probs = torch.sigmoid(logits.float()) * sample_mask
    pred = (probs > 0.5).float()
    yv = y * sample_mask
    return [(pred * yv).sum(), pred.sum(), yv.sum()]


def counts_to_metrics(c: dict) -> tuple[float, float]:
    """(dice, iou) from one batch's summed counts (host numbers or tensors)."""
    inter, sp, st = float(c["inter"]), float(c["sum_pred"]), float(c["sum_true"])
    dice = 2 * inter / (sp + st) if sp + st > 0 else 0.0
    union = sp + st - inter
    iou = inter / union if union > 0 else 0.0
    return dice, iou
