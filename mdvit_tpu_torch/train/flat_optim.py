"""Flat AdamW (``mdvit_tpu/train/flat_optim.py``): one fp32 first moment and
one fp32 second moment over all the parameters, laid end to end in their
order, updated in one pass over the flat buffer:

  m ← β₁·m + (1−β₁)·g;  v ← β₂·v + (1−β₂)·g²
  m̂ = m / (1 − β₁ᵏ);  v̂ = v / (1 − β₂ᵏ)        (k the step, from 1; optax's
                                                 bias correction)
  p ← p − lr·(m̂ / (√v̂ + eps) + wd·p)

A callable ``learning_rate`` is evaluated at the pre-increment count (the
first update takes ``learning_rate(0)``), as ``optax.scale_by_schedule``
does. ``weight_decay=0`` is Adam. The update is plain PyTorch on the flat
buffer (this is no TPU kernel of the JAX package).
"""
from __future__ import annotations

from typing import Callable, Iterable, Union

import torch


class FlatAdamW:
    """``step()`` applies one update from the parameters' ``.grad``; the
    moments are ``m`` and ``v``, (n,) fp32, and ``count`` the updates made."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[float, Callable[[int], float]], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.wd = learning_rate, b1, b2, eps, weight_decay
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.m = torch.zeros(n, dtype=torch.float32, device=dev)
        self.v = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = 0

    def _flat(self, tensors) -> torch.Tensor:
        return torch.cat([t.detach().float().reshape(-1) for t in tensors])

    @torch.no_grad()
    def step(self) -> None:
        g = self._flat(p.grad if p.grad is not None else torch.zeros_like(p)
                       for p in self.params)
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        self.m.mul_(self.b1).add_(g * (1.0 - self.b1))
        self.v.mul_(self.b2).add_((g * g) * (1.0 - self.b2))
        k = torch.tensor(float(self.count), dtype=torch.float32)
        c1 = (1.0 - torch.tensor(self.b1, dtype=torch.float32) ** k).to(g.device)
        c2 = (1.0 - torch.tensor(self.b2, dtype=torch.float32) ** k).to(g.device)
        upd = (self.m / c1) / (torch.sqrt(self.v / c2) + self.eps)
        if self.wd != 0.0:
            upd = upd + self.wd * self._flat(self.params)
        upd = -lr * upd
        for p, u in zip(self.params, upd.split([p.numel() for p in self.params])):
            p.add_(u.view_as(p).to(p.dtype))


def flat_adamw(params: Iterable[torch.nn.Parameter],
               learning_rate: Union[float, Callable[[int], float]], b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0) -> FlatAdamW:
    """AdamW over ``params`` laid end to end (module docstring)."""
    return FlatAdamW(params, learning_rate, b1, b2, eps, weight_decay)
