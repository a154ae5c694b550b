"""MPViT, the multi-path classifier (``mdvit_tpu/models/mpvit.py``).

A stem of two strided ConvBNs, then four stages. Each stage runs
``num_path`` depthwise-separable patch embeds one after another (the first
downsamples from stage 1 on), and each embed's output is one path: a
factorized-attention ``MHSAStage`` (kernels A, B and C, no Sup gate) per
path, beside a convolutional ``ResBlock`` on the first path's input. The
paths' outputs are concatenated and a 1×1 ConvBN aggregates them to the
next stage's width. The head pools stage 4 over space and a linear layer
gives the logits.

The stages are NHWC grids; each path's tokens go through its ``MHSAStage``
as (B, H·W, C) and back. The modules keep the flax names (``stem1``,
``stage{i}_embed{p}``, ``stage{i}_invres``, ``stage{i}_path{p}``,
``stage{i}_aggregate``, ``cls``), so ``convert.from_jax_variables`` maps
the JAX model's leaves by name.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.ops.layers import Conv2d, ConvBN, DWConvBN, Linear
from mdvit_tpu_torch.ops.norm import make_bn
from mdvit_tpu_torch.parallel.mesh import spatial_mean


class ResBlock(nn.Module):
    """The convolutional path (``mpvit.py:ResBlock``): 1×1 ConvBN + hardswish,
    3×3 depthwise conv, BN, hardswish, 1×1 ConvBN, plus the input."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBN(features, features, 1, act="hardswish", dtype=dtype)
        self.dwconv = Conv2d(features, features, 3, 1, 1, groups=features, bias=False,
                             dtype=dtype)
        self.norm = make_bn(features)
        self.conv2 = ConvBN(features, features, 1, act=None, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        feat = self.dwconv(self.conv1(x, None, train))
        feat = F.hardswish(self.norm(feat, None, train))
        return x + self.conv2(feat, None, train)


class MPViT(nn.Module):
    """Multi-path ViT classifier: ``{"logits": (B, num_classes), "feat": (B, C₄)}``.

    Every layer has its row-sharded form (``parallel/context.py``): the
    stem's and embeds' strided convs take halo rows, the pool is the whole
    grid's (``spatial_mean``), so the logits come out the same on every
    rank."""

    context_parallel_gap = None
    total_stride = 32  # the stem /4, then /2 at stages 2 to 4
    # the row-changing ops (parallel/context.py): two stride-2 stems and the
    # first embeds of stages 2 to 4, 3×3 with SAME padding (⌈R/2⌉ rows)
    row_chain = (("same", 2),) * 5

    def __init__(self, num_classes: int = 1000, num_path: Sequence[int] = (2, 3, 3, 3),
                 num_layers: Sequence[int] = (1, 2, 4, 1),
                 embed_dims: Sequence[int] = (64, 96, 176, 216),
                 mlp_ratios: Sequence[float] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (8, 8, 8, 8), drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = tuple(embed_dims)
        self.num_path = tuple(num_path)
        self.stem1 = ConvBN(3, dims[0] // 2, 3, 2, 1, act="hardswish", dtype=dtype)
        self.stem2 = ConvBN(dims[0] // 2, dims[0], 3, 2, 1, act="hardswish", dtype=dtype)
        # stochastic depth rising linearly over all blocks of all stages
        dpr = np.linspace(0, drop_path_rate, sum(num_layers))
        cur = 0
        for i in range(4):
            rates = [float(d) for d in dpr[cur:cur + num_layers[i]]]
            cur += num_layers[i]
            for p in range(self.num_path[i]):
                self.add_module(f"stage{i}_embed{p}", DWConvBN(
                    dims[i], dims[i], 3, stride=2 if i > 0 and p == 0 else 1,
                    dw_groups_on="in", dtype=dtype))
            self.add_module(f"stage{i}_invres", ResBlock(dims[i], dtype=dtype))
            for p in range(self.num_path[i]):
                self.add_module(f"stage{i}_path{p}", MHSAStage(
                    dims[i], num_layers[i], num_heads[i], mlp_ratios[i], 1, sup=False,
                    dsn=False, dtype=dtype, drop_path_list=rates))
            out_dim = dims[i + 1] if i + 1 < 4 else dims[i]
            self.add_module(f"stage{i}_aggregate", ConvBN(
                dims[i] * (self.num_path[i] + 1), out_dim, 1, act="hardswish", dtype=dtype))
        self.cls = Linear(dims[3], num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, gen: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x (B, H, W, 3) normalised images; ``domain_onehot`` is ignored (the
        JAX module's signature); ``gen`` drives stochastic depth when
        ``train``."""
        x = self.stem2(self.stem1(x, None, train), None, train)
        for i in range(4):
            paths = []
            for p in range(self.num_path[i]):
                x = getattr(self, f"stage{i}_embed{p}")(x, None, train)
                paths.append(x)
            outs = [getattr(self, f"stage{i}_invres")(paths[0], train)]
            for p, feat in enumerate(paths):
                b, h, w, c = feat.shape
                tokens = getattr(self, f"stage{i}_path{p}")(
                    feat.reshape(b, h * w, c), (h, w), None, train, gen)
                outs.append(tokens.reshape(b, h, w, c))
            x = getattr(self, f"stage{i}_aggregate")(torch.cat(outs, dim=-1), None, train)
        feat = spatial_mean(x)
        return {"logits": self.cls(feat), "feat": feat}


# the JAX builders' configurations (``mpvit.py:_factory`` calls)
CONFIGS = {
    "mpvit_tiny": dict(num_path=(2, 3, 3, 3), num_layers=(1, 2, 4, 1),
                       embed_dims=(64, 96, 176, 216), mlp_ratios=(2, 2, 2, 2)),
    "mpvit_xsmall": dict(num_path=(2, 3, 3, 3), num_layers=(1, 2, 4, 1),
                         embed_dims=(64, 128, 192, 256), mlp_ratios=(4, 4, 4, 4)),
    "mpvit_small": dict(num_path=(2, 3, 3, 3), num_layers=(1, 3, 6, 3),
                        embed_dims=(64, 128, 216, 288), mlp_ratios=(4, 4, 4, 4)),
    "mpvit_base": dict(num_path=(2, 3, 3, 3), num_layers=(1, 3, 8, 3),
                       embed_dims=(128, 224, 368, 480), mlp_ratios=(4, 4, 4, 4)),
}
