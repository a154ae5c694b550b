"""Decoders (``mdvit_tpu/models/decoders.py``), NHWC: the U-Net transformer
decoding block, and the debranches of MDViT: ``MLPDecoder``, ``MLPDecoderFM``
and ``DeepLabV3Decoder`` (with ``ASPP``). A debranch sees one domain's
samples, so its BNs are plain and take their moments as one group."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.ops.layers import (Conv2d, ConvBN, DWConvBN, dropout2d,
                                        fast_dropout)
from mdvit_tpu_torch.ops.norm import DomainBatchNorm, NormSpec
from mdvit_tpu_torch.ops.resize import local_size, resize_bilinear
from mdvit_tpu_torch.parallel.mesh import spatial_mean


class UnetDecodingBlockTransformer(nn.Module):
    """1×1 ``conv_before`` → resize to the skip → concat(skip, ·) →
    ``conv_after`` (grouped 2C→C DWConvBN) → ``mhsa_block``, plus
    ``res_conv`` (1×1 ConvBN, no act) of ``conv_after``'s output when
    ``use_res``; ``norm`` says how the BNs treat domains.

    The 1×1 conv runs before the resize (they commute; the JAX package's
    order, kept so the rounding matches)."""

    def __init__(self, in_channels: int, out_channels: int, mhsa: MHSAStage,
                 use_res: bool = False, norm: NormSpec = NormSpec(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_before = Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.conv_after = DWConvBN(2 * out_channels, out_channels, 3,
                                   dw_groups_on="out", norm=norm, dtype=dtype)
        self.use_res = use_res
        if use_res:
            self.res_conv = ConvBN(out_channels, out_channels, 1, act=None, norm=norm,
                                   dtype=dtype)
        self.mhsa_block = mhsa

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                domain_onehot: torch.Tensor | None, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        size = (skip.shape[1], skip.shape[2])
        out = resize_bilinear(self.conv_before(x), size)
        out = torch.cat([skip, out.to(skip.dtype)], dim=-1)  # skip first
        out = self.conv_after(out, domain_onehot, train)
        tokens = self.mhsa_block(out.flatten(1, 2), size, domain_onehot, train, gen)
        tokens = tokens.unflatten(1, size)
        if self.use_res:
            return self.res_conv(out, domain_onehot, train) + tokens
        return tokens


class MLPDecoderFM(nn.Module):
    """MLP decoder over the four encoder scales plus the H/4 universal
    decoder feature (reference ``MLPDecoderFM``): ``linear1..4`` → resize to
    H/4 → concat with the feature → ``linear_fuse`` (1×1 conv, BN, ReLU) →
    ``Dropout2d(0.1)`` → ``linear_out`` (one channel) → resize. MDViT's
    debranches have 512 hidden channels. ``fm_channels=0`` is the plain
    ``MLPDecoder``: no universal feature."""

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
        self.fm = fm_channels > 0

    def forward(self, features: Sequence[torch.Tensor], train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """features: [s0, s1, s2, s3] and, with a universal feature, the
        decoder output (H/4) last."""
        size = (features[0].shape[1], features[0].shape[2])
        outs = [resize_bilinear(getattr(self, f"linear{i + 1}")(f), size)
                for i, f in enumerate(features[:self.n_scales])]
        if self.fm:
            outs.append(features[self.n_scales].to(outs[0].dtype))
        out = self.linear_fuse[0](torch.cat(outs, dim=-1))
        out = F.relu(self.linear_fuse[1](out, None, train))
        out = dropout2d(out, self.dropout_ratio, train, gen)
        return resize_bilinear(self.linear_out(out), local_size(self.img_size))


class MLPDecoder(MLPDecoderFM):
    """The SegFormer-style debranch (``decoders.py:MLPDecoder``): the four
    encoder scales only."""

    def __init__(self, in_dims: Sequence[int], img_size: Tuple[int, int] = (256, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_dims, 0, img_size, dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (``decoders.py:ASPP``): a 1×1 branch
    ``b0``, three dilated 3×3 branches ``b1..b3`` (rates 6, 12, 18) and a
    global-pool branch ``pool``, each conv → BN → ReLU; concat →
    ``project`` (1×1 conv, BN, ReLU) → dropout 0.1. The dropout hashes
    counters (``fast_dropout``): flax's threefry mask cannot be matched.
    Under context parallelism the dilated convs take halos from every rank
    they reach and the pool is the whole grid's (``spatial_mean``)."""

    dropout_ratio = 0.1

    def __init__(self, in_channels: int, out_channels: int = 256,
                 rates: Tuple[int, int, int] = (6, 12, 18),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = out_channels
        self.b0_conv = Conv2d(in_channels, c, 1, bias=False, dtype=dtype)
        self.b0_bn = DomainBatchNorm(c)
        for i, r in enumerate(rates):
            self.add_module(f"b{i + 1}_conv", Conv2d(in_channels, c, 3, padding=r,
                                                     dilation=r, bias=False, dtype=dtype))
            self.add_module(f"b{i + 1}_bn", DomainBatchNorm(c))
        self.pool_conv = Conv2d(in_channels, c, 1, bias=False, dtype=dtype)
        self.pool_bn = DomainBatchNorm(c)
        self.project_conv = Conv2d(c * (len(rates) + 2), c, 1, bias=False, dtype=dtype)
        self.project_bn = DomainBatchNorm(c)
        self.n_rates = len(rates)

    def _branch(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = getattr(self, f"{name}_conv")(x)
        return F.relu(getattr(self, f"{name}_bn")(y, None, train))

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        branches = [self._branch(f"b{i}", x, train) for i in range(self.n_rates + 1)]
        pooled = self._branch("pool", spatial_mean(x)[:, None, None], train)
        branches.append(pooled.expand(-1, x.shape[1], x.shape[2], -1))
        out = self._branch("project", torch.cat(branches, dim=-1), train)
        return fast_dropout(out, self.dropout_ratio, train, gen)


class DeepLabV3Decoder(nn.Module):
    """ASPP + conv head, the MDViT^D debranch (``decoders.py:DeepLabV3Decoder``):
    takes the last (H/32) encoder feature; ``head_conv`` 3×3 → ``head_bn``
    → ReLU → ``head_out`` 1×1 → resize."""

    def __init__(self, in_channels: int, img_size: Tuple[int, int] = (256, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.aspp = ASPP(in_channels, dtype=dtype)
        self.head_conv = Conv2d(256, 256, 3, padding=1, bias=False, dtype=dtype)
        self.head_bn = DomainBatchNorm(256)
        self.head_out = Conv2d(256, 1, 1, dtype=dtype)
        self.img_size = tuple(img_size)

    def forward(self, features: Sequence[torch.Tensor], train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        x = self.aspp(features[-1], train, gen)
        x = F.relu(self.head_bn(self.head_conv(x), None, train))
        return resize_bilinear(self.head_out(x), local_size(self.img_size))
