"""MDViT (``mdvit_tpu/models/mdvit.py``): the factorized-attention U-Net with
the Sup domain gate, a 1×1 ``finalconv`` head and four MLPFM debranches
``debranch{1..4}`` (reference names).

Aux modes:

* ``"none"`` (serving): ``{"seg": (logits, None), "feat": ...}``;
* ``"grouped"`` (the MKD train step): the batch is D equal domain-contiguous
  groups; each debranch runs on its own domain's group only, so only its BN
  stats move, and the aux logits are re-stacked to (D·B, H, W, 1);
* ``"select"`` (eval of mixed-domain batches): every debranch runs on the
  whole batch in eval mode and each sample's one-hot picks its output;
* ``"features"`` (the eval step): the debranches are skipped and the output
  carries ``aux_features``; the caller applies ``debranch_module(d)``, the
  one debranch of a single-domain batch's domain.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from mdvit_tpu_torch.models.base import FATEncoderDecoder
from mdvit_tpu_torch.models.decoders import MLPDecoderFM
from mdvit_tpu_torch.ops.layers import Conv2d
from mdvit_tpu_torch.ops.resize import resize_bilinear


class MDViT(FATEncoderDecoder):
    def __init__(self, img_size: int = 256,
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 num_heads: Sequence[int] = (8, 8, 8, 8),
                 num_domains: int = 4, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__(num_layers, embed_dims, mlp_ratios, num_heads,
                         num_domains, drop_rate, drop_path_rate, dtype)
        self.num_domains = num_domains
        dims = tuple(embed_dims)
        self.finalconv = nn.Sequential(Conv2d(dims[0], 1, 1, dtype=dtype))
        for d in range(1, num_domains + 1):
            self.add_module(f"debranch{d}", MLPDecoderFM(
                dims, dims[0], img_size=(img_size, img_size), dtype=dtype))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor,
                train: bool = False, out_feat: bool = False,
                aux_mode: str = "none",
                gen: torch.Generator | None = None) -> dict[str, Any]:
        """x (B, H, W, 3) normalised images, domain_onehot (B, D); ``gen``
        drives dropout and stochastic depth when ``train``.

        Returns ``{"seg": (logits (B, H, W, 1), aux logits or None),
        "feat": (B, C₄) or None}``; ``feat`` is the spatial mean of stage 4
        when ``out_feat``."""
        if aux_mode not in ("none", "grouped", "select", "features"):
            raise ValueError(f"unknown aux_mode {aux_mode!r}")
        encoder_outs, dec = self.forward_features(x, domain_onehot, train, gen)
        feat = encoder_outs[3].mean(dim=(1, 2)) if out_feat else None
        # the 1×1 finalconv commutes with the upsample: conv at H/4, resize 1 channel
        logits = resize_bilinear(self.finalconv(dec), (x.shape[1], x.shape[2]))
        features = [*encoder_outs, dec]
        d = self.num_domains
        aux = None
        if aux_mode == "grouped":
            b = x.shape[0]
            if b % d:
                raise ValueError(f"grouped aux_mode needs batch ({b}) divisible "
                                 f"by num_domains ({d}), domain-contiguous")
            groups = [f.chunk(d, dim=0) for f in features]
            aux = torch.cat([self.debranch_module(i)([g[i] for g in groups], train, gen)
                             for i in range(d)])
        elif aux_mode == "select":
            outs = torch.stack([self.debranch_module(i)(features, False)
                                for i in range(d)])  # (D, B, H, W, 1)
            aux = torch.einsum("dbhwc,bd->bhwc", outs, domain_onehot.to(outs.dtype))
        elif aux_mode == "features":
            return {"seg": (logits, None), "feat": feat, "aux_features": features}
        return {"seg": (logits, aux), "feat": feat}

    def debranch_module(self, domain: int) -> MLPDecoderFM:
        """The MLPFM debranch of ``domain`` (0-based), for a single-domain
        batch (reference dispatch, ``mdvit.py:714-724``)."""
        return getattr(self, f"debranch{domain + 1}")
