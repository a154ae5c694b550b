"""Norms of MDViT (``mdvit_tpu/ops/norm.py``), channel-last, fp32 inside.

``DomainBatchNorm`` is the JAX package's shared BN. With ``group_stats``
(the default) each domain's samples are normalised in train mode with that
domain's own batch moments, as the reference's one forward per domain did,
and the shared running stats are folded once per present domain, in domain
order; without it the moments are joint over the whole batch. In eval mode
it normalises with the running stats.

``DomainBatchNormDSN`` and ``DomainLayerNormDSN`` are the DSN forms (the
reference's ``ModuleList`` of per-domain norms, ``bns.{d}`` / ``norm1s.{d}``
in the ``state_dict``): each sample's affine, and in eval its running stats,
are gathered by its one-hot; in train mode each present domain's running
stats take one momentum step towards its own moments, and an absent domain's
stay as they are.

Inside ``running_stats_frozen()`` a train-mode BatchNorm normalises as
always but writes no running stats: the recompute of an activation
checkpoint (``tpu.remat``) runs the forward again, and the stats must take
the batch's moments once, from the first forward, as JAX's do.

Under data parallelism (``parallel.mesh.sharded``) a train-mode BatchNorm
sums its moments' terms (Σx, Σx², counts) over the ranks before it divides,
differentiably, as JAX's ``psum`` does: the moments, the gradients through
them and the running stats are those of the global batch, equal on every
rank. A rank that holds no row of a group adds zeros.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, NamedTuple

import torch
from torch import nn

from mdvit_tpu_torch.parallel.mesh import all_reduce_sum, current_shard

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LN_EPS = 1e-6

_frozen = 0  # depth of running_stats_frozen()


@contextlib.contextmanager
def running_stats_frozen() -> Iterator[None]:
    """Train-mode BatchNorms leave their running stats as they are."""
    global _frozen
    _frozen += 1
    try:
        yield
    finally:
        _frozen -= 1


class NormSpec(NamedTuple):
    """How a conv-path BatchNorm treats domains (``layers.py:NormSpec``):
    ``dsn`` per-domain affine and running stats, ``group_stats`` per-domain
    batch moments in train mode."""

    num_domains: int = 1
    dsn: bool = False
    group_stats: bool = True


def _onehot(x: torch.Tensor, domain_onehot: torch.Tensor | None, d: int) -> torch.Tensor:
    if domain_onehot is not None:
        return domain_onehot.float()
    if d != 1:
        raise ValueError(f"a norm over {d} domains needs domain_onehot")
    return torch.ones((x.shape[0], 1), device=x.device)


def _bshape(x: torch.Tensor) -> tuple:
    """(B, C) → x's broadcast shape (B, 1, ..., C)."""
    return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)


def _sums_over_batch(*sums: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The batch sums (each (..., C) or (...,)) summed over the ranks of the
    current shard's group in one collective; as they are without a group."""
    group = current_shard().group
    if group is None:
        return sums
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in sums]), group)
    return tuple(part.reshape(t.shape) for part, t in
                 zip(flat.split([t.numel() for t in sums]), sums))


def _group_moments(xf: torch.Tensor, oh: torch.Tensor):
    """Masked per-domain moments (norm.py:117-128): var = E[x²] − mean²,
    clamped at 0, from s1 = Σx and s2 = Σx² over each sample's pixels.
    Returns each sample's (mean, var) broadcast to x, and per domain the
    mean, the biased variance and the count of values."""
    spatial = tuple(range(1, xf.dim() - 1))
    n_spatial = math.prod(xf.shape[1:-1])
    s1 = xf.sum(dim=spatial)                        # (B, C)
    s2 = (xf * xf).sum(dim=spatial)
    ds1, ds2, cnt = _sums_over_batch(oh.t() @ s1, oh.t() @ s2,  # (D, C), (D, C)
                                     oh.sum(dim=0) * n_spatial)  # (D,)
    cnt_safe = cnt.clamp(min=1.0)[:, None]
    dmean = ds1 / cnt_safe                          # (D, C)
    dvar = (ds2 / cnt_safe - dmean * dmean).clamp(min=0.0)
    bshape = _bshape(xf)
    return (oh @ dmean).reshape(bshape), (oh @ dvar).reshape(bshape), dmean, dvar, cnt


def _running_targets(dmean, dvar, cnt):
    """Per domain: the mean, the unbiased variance (torch semantics) and
    whether the domain is present, (D, 1)."""
    dvar_unb = dvar * cnt[:, None] / (cnt - 1.0).clamp(min=1.0)[:, None]
    return dmean, dvar_unb, (cnt > 0).float()[:, None]


def _joint_moments(xf: torch.Tensor):
    """Moments over batch and space (norm.py:156-167), and the unbiased
    variance for the running stats."""
    axes = tuple(range(xf.dim() - 1))
    n = torch.full((), float(math.prod(xf.shape[:-1])), device=xf.device)
    s1, s2, n = _sums_over_batch(xf.sum(dim=axes), (xf * xf).sum(dim=axes), n)
    mean = s1 / n.clamp(min=1.0)
    var = (s2 / n.clamp(min=1.0) - mean * mean).clamp(min=0.0)
    return mean, var, var * n / (n - 1.0).clamp(min=1.0)


class DomainBatchNorm(nn.Module):
    """BatchNorm over the last axis of (B, ..., C), eps 1e-5, momentum 0.1,
    shared affine and running stats.

    Parameter and buffer names follow ``nn.BatchNorm2d``."""

    def __init__(self, num_features: int, num_domains: int = 1,
                 group_stats: bool = True):
        super().__init__()
        self.num_domains = num_domains
        self.group_stats = group_stats
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
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var + BN_EPS)
        elif self.group_stats:
            oh = _onehot(x, domain_onehot, self.num_domains)
            mean_b, var_b, *moments = _group_moments(xf, oh)
            if not _frozen:
                with torch.no_grad():
                    dmean, dvar_unb, present = _running_targets(*moments)
                    # the reference's D sequential updates of the shared running
                    # stats, in domain order; absent domains leave them as they are
                    m = BN_MOMENTUM
                    mean, var = self.running_mean.clone(), self.running_var.clone()
                    for d in range(oh.shape[1]):
                        p = present[d]
                        mean = (1 - m * p) * mean + m * p * dmean[d]
                        var = (1 - m * p) * var + m * p * dvar_unb[d]
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
            y = (xf - mean_b) * torch.rsqrt(var_b + BN_EPS)
        else:
            mean, var, var_unb = _joint_moments(xf)
            if not _frozen:
                with torch.no_grad():
                    m = BN_MOMENTUM
                    self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var + m * var_unb)
            y = (xf - mean) * torch.rsqrt(var + BN_EPS)
        y = y * self.weight + self.bias
        return y.to(x.dtype)


class _Affine(nn.Module):
    """One domain's norm affine (``weight``, ``bias``)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))


class _BNSlot(_Affine):
    """One domain's BatchNorm: affine and running stats."""

    def __init__(self, num_features: int):
        super().__init__(num_features)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))


def _gather_affine(slots: nn.ModuleList, oh: torch.Tensor, like: torch.Tensor):
    """Each sample's (weight, bias), gathered by its one-hot, in x's shape."""
    w = oh @ torch.stack([s.weight for s in slots]).float()
    b = oh @ torch.stack([s.bias for s in slots]).float()
    return w.reshape(_bshape(like)), b.reshape(_bshape(like))


class DomainBatchNormDSN(nn.ModuleList):
    """Per-domain BatchNorm (DSN, reference ``bns = ModuleList[D]``): slot
    ``d`` holds domain d's affine and running stats."""

    def __init__(self, num_features: int, num_domains: int, group_stats: bool = True):
        super().__init__(_BNSlot(num_features) for _ in range(num_domains))
        self.group_stats = group_stats

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        xf = x.float()
        oh = _onehot(x, domain_onehot, len(self))
        ra_mean = torch.stack([s.running_mean for s in self])   # (D, C)
        ra_var = torch.stack([s.running_var for s in self])
        if not train:
            mean = (oh @ ra_mean).reshape(_bshape(x))
            var = (oh @ ra_var).reshape(_bshape(x))
            y = (xf - mean) * torch.rsqrt(var + BN_EPS)
        else:
            if self.group_stats:
                mean_b, var_b, *moments = _group_moments(xf, oh)
            else:  # every domain's stats take the joint moments (norm.py:162-167)
                mean_b, var_b, var_unb = _joint_moments(xf)
            if not _frozen:
                with torch.no_grad():
                    if self.group_stats:
                        dmean, dvar_unb, present = _running_targets(*moments)
                        step = BN_MOMENTUM * present                # (D, 1)
                    else:
                        dmean, dvar_unb, step = mean_b, var_unb, BN_MOMENTUM
                    new_mean = (1 - step) * ra_mean + step * dmean
                    new_var = (1 - step) * ra_var + step * dvar_unb
                    for d, s in enumerate(self):
                        s.running_mean.copy_(new_mean[d])
                        s.running_var.copy_(new_var[d])
            y = (xf - mean_b) * torch.rsqrt(var_b + BN_EPS)
        w, b = _gather_affine(self, oh, x)
        return (y * w + b).to(x.dtype)


def _layer_normalize(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + LN_EPS)


class DomainLayerNorm(nn.Module):
    """LayerNorm over the last axis with moments in fp32, eps 1e-6 (shared
    affine; names follow ``nn.LayerNorm``)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None
                ) -> torch.Tensor:
        return (_layer_normalize(x) * self.weight + self.bias).to(x.dtype)


class DomainLayerNormDSN(nn.ModuleList):
    """LayerNorm with a per-domain affine (``DomainLayerNorm(per_domain=True)``,
    reference ``norm1s = ModuleList[D]``), gathered by each sample's one-hot."""

    def __init__(self, num_features: int, num_domains: int):
        super().__init__(_Affine(num_features) for _ in range(num_domains))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None
                ) -> torch.Tensor:
        w, b = _gather_affine(self, _onehot(x, domain_onehot, len(self)), x)
        return (_layer_normalize(x) * w + b).to(x.dtype)


def make_bn(num_features: int, spec: NormSpec = NormSpec()) -> nn.Module:
    """The BatchNorm a ``NormSpec`` describes (``layers.py:make_bn``)."""
    if spec.dsn:
        return DomainBatchNormDSN(num_features, spec.num_domains, spec.group_stats)
    return DomainBatchNorm(num_features, spec.num_domains, spec.group_stats)


def make_ln(num_features: int, num_domains: int = 1, dsn: bool = False) -> nn.Module:
    return DomainLayerNormDSN(num_features, num_domains) if dsn else DomainLayerNorm(
        num_features)
