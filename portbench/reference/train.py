"""The train step and the serving forward of MDViT and BASE in plain
PyTorch, for the benchmark's output check.

A step: gather each domain's rows from the uint8 stores, augment (draws from
a generator on the stores' device), forward, per-domain losses, gradients,
AdamW with the staircase StepLR. MDViT's objective (MKD): per domain the
segmentation loss L_seg (BCE + squared-denominator dice), the debranch's
L_aux and the distillation L_kt = dice(σ(aux), σ(seg)); every parameter
takes ∂(ΣL_aux + α·ΣL_kt + (1−α)·ΣL_seg), but the Sup gates'
(``domain_layer``) take ∂(α·ΣL_kt + (1−α)·ΣL_seg) alone. BASE's is ΣL_seg.
Every term is a sum over domains of one domain's rows, so the step is
computed a domain at a time and the gradients summed: the peak is that of
one domain's rows.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from portbench.reference import rng
from portbench.reference.model import Ctx, Model

SMOOTH = 1e-5


def dice_loss(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """1 − (2Σpt + s)/(Σp² + Σt² + s)."""
    return 1.0 - (2.0 * (p * t).sum() + SMOOTH) / ((p * p).sum() + (t * t).sum() + SMOOTH)


def seg_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """BCE (mean over the values) + dice of σ(logits)."""
    return (F.binary_cross_entropy_with_logits(logits, y)
            + dice_loss(torch.sigmoid(logits), y))


class AdamW:
    """torch's AdamW, written out: decoupled weight decay, bias-corrected
    moments; the learning rate of update k (from 0) is
    lr · gamma^⌊k / (step_size · steps_per_epoch)⌋."""

    def __init__(self, params: Sequence[torch.Tensor], opt: dict, steps_per_epoch: int):
        self.params = list(params)
        self.opt, self.transition = opt, opt["step_size"] * steps_per_epoch
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.k = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        o = self.opt
        lr = o["lr"] * o["gamma"] ** (self.k // self.transition)
        b1, b2 = o["betas"]
        self.k += 1
        c1, c2 = 1 - b1 ** self.k, 1 - b2 ** self.k
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * o["weight_decay"])
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + o["eps"], value=-lr / c1)


def set_precision(tf32: bool) -> None:
    """fp32 products and convolutions in full fp32 (cuBLAS's ``highest``
    precision and cuDNN's ``allow_tf32`` off: ``allow_tf32 = False`` on
    both backends), or in TF32 (the control). These are the switches the
    system's own ``device.no_tf32`` turns; PyTorch refuses to mix them with
    the legacy ``torch.backends.cuda.matmul.allow_tf32``."""
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cudnn.allow_tf32 = tf32


def build(cfg: dict) -> Model:
    """The configuration's model (on the current default device)."""
    return Model("mdvit" if cfg["adapt_method"] == "Sup" else "base", cfg["img_size"],
                 cfg["embed_dims"], cfg["num_layers"], cfg["mlp_ratios"], cfg["num_heads"],
                 cfg["num_domains"])


class Step:
    """The reference's train step over the model ``model`` and the
    per-domain uint8 stores; ``seed`` seeds its dropout generator (CPU) and
    its augmentation generator (the stores' device), as the step under test
    seeds its own."""

    def __init__(self, model: Model, cfg: dict, steps_per_epoch: int, seed: int,
                 augment: bool = True):
        self.model, self.cfg, self.augment = model, cfg, augment
        self.named = list(model.named_parameters())
        self.params = [p for _, p in self.named]
        self.masked = {i for i, (n, _) in enumerate(self.named) if "domain_layer" in n}
        self.opt = AdamW(self.params, cfg["optimizer"], steps_per_epoch)
        self.gen = torch.Generator().manual_seed(seed)
        if augment:
            self.aug_gen = torch.Generator(device=self.params[0].device).manual_seed(seed)

    def grads(self, images, masks, indices: torch.Tensor, keep: int | None = None):
        """(losses {name: 0-d tensor}, gradients) of one step's batch,
        before the update; ``indices`` (D, B) selects rows of the first D
        domains' stores. ``keep``: only each domain's first ``keep`` rows
        take part (a planted fault: part of the batch left out)."""
        d, b = indices.shape
        mkd = self.model.kind == "mdvit" and self.cfg["mkd"]
        alpha = self.cfg["alpha"]
        params = self.params
        if self.augment:
            p = rng.aug_params(self.aug_gen, d * b, params[0].device)
        tape = rng.SeedTape(self.gen)
        total = [torch.zeros_like(q) for q in params]
        gated = {i: torch.zeros_like(params[i]) for i in self.masked}
        sums = {"loss": 0.0, "aux_loss": 0.0, "kt_loss": 0.0}
        width = self.model.domains
        for i in range(d):
            x = images[i][indices[i]].float()
            m = masks[i][indices[i]].float()
            if self.augment:
                x, y = rng.augment(x, m, p, i * b)
            else:
                x, y = rng.normalize(x), (m > 0.5).float()[..., None]
            if keep is not None:
                x, y = x[:keep], y[:keep]
            onehot = F.one_hot(torch.full((x.shape[0],), i, device=x.device), width).float()
            tape.rewind()
            ctx = Ctx(tape, i * b, self.cfg["drop_rate"], self.cfg["drop_path_rate"])
            logits, aux = self.model(x, onehot, ctx, domain=i if mkd else None)
            seg = seg_loss(logits, y)
            if mkd:
                aux_l = seg_loss(aux, y)
                kt = dice_loss(torch.sigmoid(aux), torch.sigmoid(logits))
                uni = alpha * kt + (1 - alpha) * seg
                g_all = torch.autograd.grad(aux_l + uni, params, retain_graph=bool(gated),
                                            allow_unused=True)
                if gated:
                    g_uni = torch.autograd.grad(uni, [params[j] for j in gated],
                                                allow_unused=True)
                    for j, g in zip(gated, g_uni):
                        if g is not None:
                            gated[j] += g
                sums["aux_loss"] += aux_l.detach()
                sums["kt_loss"] += kt.detach()
            else:
                g_all = torch.autograd.grad(seg, params, allow_unused=True)
            for t, g in zip(total, g_all):
                if g is not None:
                    t += g
            sums["loss"] += seg.detach()
        if not mkd:
            return {"loss": sums["loss"]}, total
        for j, g in gated.items():
            total[j] = g
        return sums, total

    def __call__(self, images, masks, indices, keep: int | None = None):
        """One step: ({name: float} losses, gradients as the update took them)."""
        losses, grads = self.grads(images, masks, indices, keep)
        self.opt.step(grads)
        return {k: float(v) for k, v in losses.items()}, grads


@torch.no_grad()
def serve(model: Model, images: torch.Tensor, onehot: torch.Tensor, rows: int = 32
          ) -> torch.Tensor:
    """σ(logits) (B, H, W) of 0..255 NHWC ``images``, eval mode, in blocks
    of ``rows`` images."""
    out = [torch.sigmoid(model(rng.normalize(images[i:i + rows]), onehot[i:i + rows],
                               Ctx())[0])[..., 0] for i in range(0, images.shape[0], rows)]
    return torch.cat(out)
