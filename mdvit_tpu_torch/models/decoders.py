"""Decoders (``mdvit_tpu/models/decoders.py``): the U-Net transformer
decoding block and the MLPFM debranch of MDViT, NHWC."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.ops.layers import Conv2d, DWConvBN, dropout2d
from mdvit_tpu_torch.ops.norm import DomainBatchNorm
from mdvit_tpu_torch.ops.resize import resize_bilinear


class UnetDecodingBlockTransformer(nn.Module):
    """1×1 ``conv_before`` → resize to the skip → concat(skip, ·) →
    ``conv_after`` (grouped 2C→C DWConvBN) → ``mhsa_block``.

    The 1×1 conv runs before the resize (they commute; the JAX package's
    order, kept so the rounding matches)."""

    def __init__(self, in_channels: int, out_channels: int, mhsa: MHSAStage,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_before = Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.conv_after = DWConvBN(2 * out_channels, out_channels, 3,
                                   dw_groups_on="out", dtype=dtype)
        self.mhsa_block = mhsa

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                domain_onehot: torch.Tensor, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        size = (skip.shape[1], skip.shape[2])
        out = resize_bilinear(self.conv_before(x), size)
        out = torch.cat([skip, out.to(skip.dtype)], dim=-1)  # skip first
        out = self.conv_after(out, domain_onehot, train)
        tokens = self.mhsa_block(out.flatten(1, 2), size, domain_onehot, train, gen)
        return tokens.unflatten(1, size)


class MLPDecoderFM(nn.Module):
    """MLP decoder over the four encoder scales plus the H/4 universal
    decoder feature (reference ``MLPDecoderFM``): ``linear1..4`` → resize to
    H/4 → concat with the feature → ``linear_fuse`` (1×1 conv, BN, ReLU) →
    ``Dropout2d(0.1)`` → ``linear_out`` (one channel) → resize. MDViT's
    debranches have 512 hidden channels. Each debranch sees one domain's
    samples, so its BN takes their moments as one group."""

    dropout_ratio = 0.1

    def __init__(self, in_dims: Sequence[int], fm_channels: int,
                 img_size: Tuple[int, int] = (256, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = 512
        self.img_size = tuple(img_size)
        for i, c in enumerate(in_dims):
            self.add_module(f"linear{i + 1}", Conv2d(c, hidden, 1, dtype=dtype))
        self.linear_fuse = nn.ModuleList([
            Conv2d(len(in_dims) * hidden + fm_channels, hidden, 1, dtype=dtype),
            DomainBatchNorm(hidden)])
        self.linear_out = Conv2d(hidden, 1, 1, dtype=dtype)
        self.n_scales = len(in_dims)

    def forward(self, features: Sequence[torch.Tensor], train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """features: [s0, s1, s2, s3, universal decoder output (H/4)]."""
        size = (features[0].shape[1], features[0].shape[2])
        outs = [resize_bilinear(getattr(self, f"linear{i + 1}")(f), size)
                for i, f in enumerate(features[:self.n_scales])]
        outs.append(features[self.n_scales].to(outs[0].dtype))
        out = self.linear_fuse[0](torch.cat(outs, dim=-1))
        out = F.relu(self.linear_fuse[1](out, None, train))
        out = dropout2d(out, self.dropout_ratio, train, gen)
        return resize_bilinear(self.linear_out(out), self.img_size)
