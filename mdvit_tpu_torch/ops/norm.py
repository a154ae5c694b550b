"""Norms of MDViT (``mdvit_tpu/ops/norm.py``), channel-last, fp32 inside.

``DomainBatchNorm`` is the JAX package's shared BN with ``group_stats=True``:
in eval mode it normalises with the running stats; in train mode each
domain's samples are normalised with that domain's own batch moments, as the
reference's one forward per domain did, and the shared running stats are
folded once per present domain, in domain order. The per-domain (DSN) forms
are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn


class DomainBatchNorm(nn.Module):
    """BatchNorm over the last axis of (B, ..., C), eps 1e-5, momentum 0.1.

    Parameter and buffer names follow ``nn.BatchNorm2d``."""

    eps = 1e-5
    momentum = 0.1

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        """``domain_onehot`` (B, D) picks each sample's domain in train mode;
        None means one domain."""
        xf = x.float()
        if not train:
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        else:
            y = self._train_normalize(xf, domain_onehot)
        y = y * self.weight + self.bias
        return y.to(x.dtype)

    def _train_normalize(self, xf: torch.Tensor, domain_onehot) -> torch.Tensor:
        """Masked per-domain moments (norm.py:117-155): var = E[x²] − mean²,
        clamped at 0, from s1 = Σx and s2 = Σx² over each sample's pixels."""
        bsz, c = xf.shape[0], xf.shape[-1]
        oh = (torch.ones((bsz, 1), device=xf.device) if domain_onehot is None
              else domain_onehot.float())
        spatial = tuple(range(1, xf.dim() - 1))
        n_spatial = xf[0, ..., 0].numel()
        s1 = xf.sum(dim=spatial)                        # (B, C)
        s2 = (xf * xf).sum(dim=spatial)
        cnt = oh.sum(dim=0) * n_spatial                 # (D,)
        cnt_safe = cnt.clamp(min=1.0)[:, None]
        dmean = (oh.t() @ s1) / cnt_safe                # (D, C)
        dvar = ((oh.t() @ s2) / cnt_safe - dmean * dmean).clamp(min=0.0)
        bshape = (bsz,) + (1,) * len(spatial) + (c,)
        mean_b = (oh @ dmean).reshape(bshape)
        var_b = (oh @ dvar).reshape(bshape)
        with torch.no_grad():
            # the reference's D sequential updates of the shared running
            # stats, in domain order, with the unbiased variance; absent
            # domains leave them as they are
            m = self.momentum
            dvar_unb = dvar * cnt[:, None] / (cnt - 1.0).clamp(min=1.0)[:, None]
            present = (cnt > 0).float()[:, None]
            mean, var = self.running_mean.clone(), self.running_var.clone()
            for d in range(oh.shape[1]):
                p = present[d]
                mean = (1 - m * p) * mean + m * p * dmean[d]
                var = (1 - m * p) * var + m * p * dvar_unb[d]
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
        return (xf - mean_b) * torch.rsqrt(var_b + self.eps)


class DomainLayerNorm(nn.Module):
    """LayerNorm over the last axis with moments in fp32, eps 1e-6 (shared
    affine; names follow ``nn.LayerNorm``)."""

    eps = 1e-6

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)
