"""SE-style universal adapters (``mdvit_tpu/models/adapters.py``), NHWC.

* ``SELayer``: pool → fc1 → ReLU → fc2 (→ sigmoid), a (B, 1, 1, C) vector;
* ``SEBlock`` (USE-Net): ``se(x)·x + x``;
* ``DomainAttention`` (DASE): N sigmoid-free SE vectors mixed by a softmax
  (fp32) over a per-image assignment ``fc_1``, then one sigmoid gate; it
  reads no domain label;
* ``ResidualAdapter`` (Rebuffi): a per-domain 1×1 conv picked by the
  one-hot, then a per-domain BN, in series (``x + y``) or parallel (``y``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from mdvit_tpu_torch.ops.layers import Linear
from mdvit_tpu_torch.ops.norm import NormSpec, make_bn
from mdvit_tpu_torch.parallel.mesh import spatial_mean


class SELayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 16, with_sigmoid: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(channel, channel // reduction, dtype=dtype)
        self.fc2 = Linear(channel // reduction, channel, dtype=dtype)
        self.with_sigmoid = with_sigmoid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc2(torch.relu(self.fc1(spatial_mean(x))))
        if self.with_sigmoid:
            y = torch.sigmoid(y)
        return y[:, None, None, :]


class SEBlock(nn.Module):
    def __init__(self, channel: int, reduction: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.se_layer = SELayer(channel, reduction, True, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.se_layer(x) * x + x


class DomainAttention(nn.Module):
    def __init__(self, planes: int, reduction: int = 16, num_adapters: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_1 = Linear(planes, num_adapters, dtype=dtype)
        for i in range(num_adapters):
            self.add_module(f"se{i}", SELayer(planes, reduction, False, dtype))
        self.num_adapters = num_adapters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = torch.softmax(self.fc_1(spatial_mean(x)).float(), dim=1)  # (B, N)
        mat = torch.stack([getattr(self, f"se{i}")(x)[:, 0, 0, :]
                           for i in range(self.num_adapters)], dim=-1)  # (B, C, N)
        mixed = torch.einsum("bcn,bn->bc", mat, weight.to(mat.dtype))
        return x * torch.sigmoid(mixed)[:, None, None, :]


class ResidualAdapter(nn.Module):
    """``weight`` (D, C_in, C_out), the JAX package's domain-stacked 1×1 conv
    kernel, normal(0, √(2 / fan_out)) with fan_out = D·C_out as flax counts
    it, applied in fp32 as JAX does; the BN is per domain (``bns.{d}``)."""

    def __init__(self, in_channels: int, channel: int, num_domains: int = 4,
                 mode: str = "series"):
        super().__init__()
        if mode not in ("series", "parallel"):
            raise ValueError(f"mode must be 'series' or 'parallel', got {mode!r}")
        self.weight = nn.Parameter(torch.empty(num_domains, in_channels, channel))
        self.bns = make_bn(channel, NormSpec(num_domains=num_domains, dsn=True))
        self.mode = mode

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """The weight's draw (``ops/initializers.py:init_weights_`` calls it)."""
        std = math.sqrt(2.0 / (self.weight.shape[0] * self.weight.shape[2]))
        self.weight.copy_(torch.empty(self.weight.shape).normal_(0.0, std,
                                                                 generator=generator))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        w = torch.einsum("bd,dio->bio", domain_onehot.to(self.weight.dtype), self.weight)
        y = torch.einsum("bhwi,bio->bhwo", x.to(w.dtype), w).to(x.dtype)
        y = self.bns(y, domain_onehot, train)
        return x + y if self.mode == "series" else y
