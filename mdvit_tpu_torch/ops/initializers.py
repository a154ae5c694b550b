"""The reference's effective weight init (``mdvit_tpu/ops/initializers.py``).

* Conv2d:  normal(0, √(2 / fan_out)), fan_out = k_h·k_w·out_ch / groups; bias 0
* Linear:  normal(0, 0.02) (timm's trunc_normal cuts at ±2.0 = ±100σ); bias 0
* norms:   weight 1, bias 0 (set by the modules themselves)
* a module with ``init_from(generator)`` draws its own parameters

Draws come from an explicit CPU ``torch.Generator`` and are copied to the
parameter's device, so one seed gives the same weights on the CPU and a card.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    draw = torch.empty(param.shape, dtype=torch.float32).normal_(
        0.0, std, generator=generator)
    param.copy_(draw)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every Conv2d, Linear and ``init_from`` module under
    ``module``, in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            fan_out = kh * kw * m.out_channels // m.groups
            _normal_(m.weight, math.sqrt(2.0 / fan_out), generator)
        elif isinstance(m, nn.Linear):
            _normal_(m.weight, 0.02, generator)
        elif hasattr(m, "init_from"):
            m.init_from(generator)
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
