"""The reference's loss family beyond the training criterion
(``mdvit_tpu/train/losses_extra.py``; reference ``Utils/losses.py:52-353``):
softmax consistency losses, signed-distance-field (SDF) maps and losses, and
the supervised contrastive loss. No training path of the repo calls them;
they are part of the API.

* The softmax, KL and MSE losses are fp32 with the channel axis LAST (the
  port's NHWC); the side that JAX's ``stop_gradient`` holds is ``.detach()``.
* The SDF ground-truth maps are host-side numpy + scipy, as in the JAX
  package (an EDT and a shift-based inner boundary): ``compute_sdf01``,
  ``compute_sdf1_1``, ``compute_fore_dist``. ``aaai_sdf_loss`` and
  ``sdf_kl_loss`` take the precomputed map as a tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from mdvit_tpu_torch.train.losses import dice_loss_nonsquared

_SMOOTH = 1e-5


# ---------------------------------------------------------------- softmax consistency


def softmax_dice_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Mean over classes of the non-squared dice between the two softmaxes."""
    assert input_logits.shape == target_logits.shape
    p = torch.softmax(input_logits.float(), dim=-1)
    t = torch.softmax(target_logits.float(), dim=-1)
    n = input_logits.shape[-1]
    return sum(dice_loss_nonsquared(p[..., i], t[..., i]) for i in range(n)) / n


def entropy_loss_map(p: torch.Tensor, c: int = 2) -> torch.Tensor:
    """Per-pixel entropy over the channel axis, over log(c), (..., 1)."""
    p = p.float()
    ent = -(p * torch.log(p + 1e-6)).sum(dim=-1, keepdim=True)
    return ent / torch.log(torch.tensor(float(c)))


def softmax_mse_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Elementwise squared difference of the softmaxes; the target side is
    detached."""
    assert input_logits.shape == target_logits.shape
    p = torch.softmax(input_logits.float(), dim=-1)
    t = torch.softmax(target_logits.float(), dim=-1).detach()
    return (p - t) ** 2


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Elementwise KL(target ‖ input), ``F.kl_div(log_softmax(input),
    softmax(target), reduction='none')``; the target side is detached."""
    assert input_logits.shape == target_logits.shape
    log_p = torch.log_softmax(input_logits.float(), dim=-1)
    t = torch.softmax(target_logits.float(), dim=-1).detach()
    return t * (torch.log(t.clamp(min=1e-38)) - log_p)


def symmetric_mse_loss(input1: torch.Tensor, input2: torch.Tensor) -> torch.Tensor:
    """Mean squared difference, gradients to both sides."""
    assert input1.shape == input2.shape
    d = input1.float() - input2.float()
    return (d * d).mean()


# ---------------------------------------------------------------- SDF maps (host, numpy)


def _edt(mask: np.ndarray) -> np.ndarray:
    """Euclidean distance of each nonzero pixel to the nearest zero pixel."""
    from scipy.ndimage import distance_transform_edt

    return distance_transform_edt(mask)


def _inner_boundary(posmask: np.ndarray) -> np.ndarray:
    """skimage's ``find_boundaries(mode='inner')`` of a binary 2-D mask:
    object pixels 4-adjacent to background; the array's edge, padded with
    its own value, is no boundary."""
    p = posmask.astype(bool)
    pad = np.pad(p, 1, mode="edge")
    nb_bg = ~pad[:-2, 1:-1] | ~pad[2:, 1:-1] | ~pad[1:-1, :-2] | ~pad[1:-1, 2:]
    return (p & nb_bg).astype(np.uint8)


def _per_mask(segmentation: np.ndarray, fn) -> np.ndarray:
    """``fn(posmask)`` over (B, C, ...) or (B, H, W), skipping empty masks
    and, when C > 1, the background class 0."""
    seg = segmentation.astype(np.uint8)
    if seg.ndim == 3:
        seg = seg[:, None]
    out = np.zeros(seg.shape, np.float64)
    dis_id = 0 if seg.shape[1] == 1 else 1
    for b in range(seg.shape[0]):
        for c in range(dis_id, seg.shape[1]):
            posmask = seg[b, c]
            if posmask.max() == 0:
                continue
            out[b, c] = fn(posmask)
    return out


def compute_sdf01(segmentation: np.ndarray) -> np.ndarray:
    """Normalised SDF in [0, 1]: 0.5 on the boundary, below 0.5 inside."""

    def one(posmask):
        posdis, negdis = _edt(posmask), _edt(1 - posmask)
        sdf = (negdis / max(negdis.max(), 1e-12) / 2
               - posdis / max(posdis.max(), 1e-12) / 2 + 0.5)
        sdf[_inner_boundary(posmask) > 0] = 0.5
        return sdf

    return _per_mask(segmentation, one)


def compute_sdf1_1(segmentation: np.ndarray) -> np.ndarray:
    """Normalised SDF in [−1, 1]: 0 on the boundary, negative inside."""

    def one(posmask):
        posdis, negdis = _edt(posmask), _edt(1 - posmask)
        sdf = negdis / max(negdis.max(), 1e-12) - posdis / max(posdis.max(), 1e-12)
        sdf[_inner_boundary(posmask) > 0] = 0
        return sdf

    return _per_mask(segmentation, one)


def compute_fore_dist(segmentation: np.ndarray) -> np.ndarray:
    """Normalised foreground distance map."""

    def one(posmask):
        posdis = _edt(posmask)
        return posdis / max(posdis.max(), 1e-12)

    return _per_mask(segmentation, one)


# ---------------------------------------------------------------- SDF losses


def aaai_sdf_loss(net_output: torch.Tensor, gt_sdm: torch.Tensor) -> torch.Tensor:
    """The AAAI SDF product loss plus L1; ``gt_sdm`` is ``compute_sdf1_1`` of
    the ground truth (detached). Shapes (B, C, ...), axes 2+ spatial."""
    out = net_output.float()
    gt = gt_sdm.float().detach()
    axes = tuple(range(2, out.dim()))
    intersect = (out * gt).sum(dim=axes)
    pd_sum = (out * out).sum(dim=axes)
    gt_sum = (gt * gt).sum(dim=axes)
    l_product = (intersect + _SMOOTH) / (intersect + pd_sum + gt_sum)
    l1 = (out - gt).abs().sum() / out.numel()
    return -l_product.mean() + l1


def sdf_kl_loss(net_output: torch.Tensor, gt_sdf: torch.Tensor) -> torch.Tensor:
    """``F.kl_div(net_output, gt_sdf[:, 1:2] + s, reduction='batchmean')``
    with ``net_output`` in log space (the map detached)."""
    out = net_output.float()
    tgt = (gt_sdf.float().detach() + _SMOOTH)[:, 1:2]
    kl = tgt * (torch.log(tgt.clamp(min=1e-38)) - out)
    return kl.sum() / out.shape[0]


# ---------------------------------------------------------------- supervised contrastive


def supervised_contrastive_loss(projections: torch.Tensor, targets: torch.Tensor,
                                attribute: torch.Tensor | None = None,
                                temperature: float = 0.1) -> torch.Tensor:
    """SupCon over (N, D) projections: cosine similarity over T, row-max
    stabilised exp (+1e-5), positives the same target but not self, the
    denominator's negatives restricted to a matching ``attribute`` when one
    is given, and a global Σ log_prob·mask / (Σ cardinality + 1e-5)."""
    z = projections.float()
    z = z / torch.linalg.norm(z, dim=1, keepdim=True).clamp(min=1e-12)
    sim = (z @ z.t()) / temperature
    exp_sim = torch.exp(sim - sim.max(dim=1, keepdim=True).values) + 1e-5
    n = z.shape[0]
    same = targets[:, None] == targets[None, :]
    eye = torch.eye(n, dtype=torch.float32, device=z.device)
    mask_combined = same.float() * (1.0 - eye)
    cardinality = mask_combined.sum(dim=1)
    neg = (~same).float()
    if attribute is not None:
        neg = neg * (attribute[:, None] == attribute[None, :]).float()
    denom = (exp_sim * neg).sum(dim=1, keepdim=True) + exp_sim + 1e-5
    log_prob = -torch.log(exp_sim / denom)
    return (log_prob * mask_combined).sum() / (cardinality.sum() + 1e-5)
