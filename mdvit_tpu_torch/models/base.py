"""The factorized-attention U-Net trunk shared by MDViT
(``mdvit_tpu/models/base.py`` ``FATEncoderDecoder``).

Stem (two ConvBN + hardswish to H/4) → four encoder stages (a DWConvBN patch
embed and an ``MHSAStage`` each) → bridge at H/32 (512 → 1024) → four
transformer decoding blocks back to H/4. Submodule names follow the original
torch MDViT: ``stem.{0,1}``, ``patch_embed_stages.i.patch_conv``,
``mhsa_stages.i``, ``bridge.{0,1,3,4}``, ``decoder{1..4}``. The universal
adapters (DASE, USE) and the per-domain norms (DSN) are not ported yet.

``train`` and the domain one-hot reach every BatchNorm (stem, patch embeds,
bridge, ``conv_after``); ``drop_rate`` and ``drop_path_rate`` reach every
block, as in the JAX module.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.models.decoders import UnetDecodingBlockTransformer
from mdvit_tpu_torch.ops.layers import Conv2d, ConvBN, DWConvBN
from mdvit_tpu_torch.ops.norm import DomainBatchNorm


class PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_conv = DWConvBN(in_ch, out_ch, 3, stride, dw_groups_on="in",
                                   dtype=dtype)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        return self.patch_conv(x, domain_onehot, train)


class FATEncoderDecoder(nn.Module):
    def __init__(self, num_layers: Sequence[int] = (2, 2, 2, 2),
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 num_heads: Sequence[int] = (8, 8, 8, 8),
                 num_domains: int = 4, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = tuple(embed_dims)
        self.stem = nn.ModuleList([
            ConvBN(3, dims[0] // 2, 3, 2, 1, dtype=dtype),  # RGB in
            ConvBN(dims[0] // 2, dims[0], 3, 2, 1, dtype=dtype)])
        self.patch_embed_stages = nn.ModuleList(
            PatchEmbed(dims[max(i - 1, 0)], dims[i], 1 if i == 0 else 2, dtype)
            for i in range(4))

        def stage(i: int) -> MHSAStage:
            return MHSAStage(dims[i], num_layers[i], num_heads[i], mlp_ratios[i],
                             num_domains, drop_rate, drop_path_rate, dtype=dtype)

        self.mhsa_stages = nn.ModuleList(stage(i) for i in range(4))
        self.bridge = nn.Sequential(
            Conv2d(dims[3], dims[3], 3, 1, 1, dtype=dtype), DomainBatchNorm(dims[3]),
            nn.ReLU(),
            Conv2d(dims[3], dims[3] * 2, 3, 1, 1, dtype=dtype),
            DomainBatchNorm(dims[3] * 2), nn.ReLU())
        in_chs = (dims[3] * 2,) + dims[:0:-1]  # 1024, 512, 320, 128
        for n in range(1, 5):
            self.add_module(f"decoder{n}", UnetDecodingBlockTransformer(
                in_chs[n - 1], dims[4 - n], stage(4 - n), dtype=dtype))

    def forward_features(self, x: torch.Tensor, domain_onehot: torch.Tensor,
                         train: bool = False, gen: torch.Generator | None = None
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(encoder_outs, decoder_feat), NHWC; the decoder feature is at H/4."""
        for conv_bn in self.stem:
            x = conv_bn(x, domain_onehot, train)
        encoder_outs = []
        for embed, stage in zip(self.patch_embed_stages, self.mhsa_stages):
            x = embed(x, domain_onehot, train)
            size = (x.shape[1], x.shape[2])
            x = stage(x.flatten(1, 2), size, domain_onehot, train, gen).unflatten(1, size)
            encoder_outs.append(x)
        conv1, bn1, _, conv2, bn2, _ = self.bridge
        out = F.relu(bn1(conv1(encoder_outs[3]), domain_onehot, train))
        out = F.relu(bn2(conv2(out), domain_onehot, train))
        for n in range(1, 5):
            out = getattr(self, f"decoder{n}")(out, encoder_outs[4 - n], domain_onehot,
                                               train, gen)
        return encoder_outs, out
