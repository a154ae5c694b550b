"""The factorized-attention transformer blocks (``mdvit_tpu/models/blocks.py``).

* ``ConvPosEnc`` (CPE): 3×3 depthwise conv plus residual → ``dwconv.cpe_conv``;
* ``ConvRelPosEnc`` (CRPE): q ⊙ (depthwise conv of v) with 3/5/7 windows over
  2/3/3 heads, zero-embedded into one 7×7 kernel → ``dwconv.crpe_conv``;
* ``FactorAtt``, with the Sup domain gate when ``sup`` →
  ``factorized_attention``;
* ``SerialBlock`` and ``MHSAStage``, with per-domain LayerNorms
  (``norm1s``/``norm2s``) when ``dsn``.

The CPE and CRPE calls, and so kernels A, B and C, are the same in every
configuration.

In train mode the blocks drop as the JAX package's do: ``FastDropout`` after
``proj`` and in the MLP at ``drop``, and stochastic depth on both residual
branches at ``drop_path``, all drawing from the caller's generator ``gen``.

Tokens are ``(B, N, C)`` with a static ``size=(H, W)`` grid. The stage owns
the shared CPE and CRPE and hands them to its blocks at call time, so they
appear once in the ``state_dict``, under ``mhsa_stages.i.{cpe, crpe}``.

Under context parallelism (``parallel.mesh.current_context()``, either
mode) the tokens are this rank's rows of the grid, ``size`` its local
(rows, W), the ranks' rows possibly unequal (``RowShard.split``): CPE and
CRPE run kernels B and C on the rows plus the
neighbours' ``k//2`` halo rows (``halo_rows``; CRPE's q, which has
no halo, zero-padded to v's rows) and keep the middle rows, and
``FactorAtt`` runs kernel A's partials, an all-gather of them and its apply
(``factorized_attention_cp``). The backward's halo-row gradients go back to
their owners through the exchange. The ``state_dict`` is the same in both
layouts.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.ops import dwconv
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import Linear, Mlp, drop_path, fast_dropout
from mdvit_tpu_torch.ops.norm import make_ln
from mdvit_tpu_torch.parallel.mesh import current_context, halo_rows

# window size → heads, in channel order (blocks.py DEFAULT_CRPE_WINDOW)
CRPE_WINDOW = {3: 2, 5: 3, 7: 3}


class ConvPosEnc(nn.Module):
    """``proj``: a depthwise 3×3 conv with bias; y = conv(x) + b + x."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        grid = x.to(self.dtype).unflatten(1, size)
        w = self.proj.weight[:, 0].permute(1, 2, 0).to(self.dtype).contiguous()
        ctx = current_context()
        if ctx is None:
            return dwconv.cpe_conv(grid, w, self.proj.bias.to(self.dtype)).flatten(1, 2)
        out = dwconv.cpe_conv(halo_rows(grid, 1, ctx), w,
                              self.proj.bias.to(self.dtype))
        return out[:, 1:-1].flatten(1, 2)


class ConvRelPosEnc(nn.Module):
    """``conv_list.{0,1,2}``: depthwise convs of windows 3/5/7 over their head
    groups; applied as one 7×7 depthwise conv gated by q."""

    def __init__(self, ch_per_head: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if sum(CRPE_WINDOW.values()) != num_heads:
            raise ValueError(f"CRPE windows {CRPE_WINDOW} do not cover {num_heads} heads")
        self.conv_list = nn.ModuleList(
            nn.Conv2d(n * ch_per_head, n * ch_per_head, k, padding=k // 2,
                      groups=n * ch_per_head)
            for k, n in CRPE_WINDOW.items())
        self.max_k = max(CRPE_WINDOW)
        self.dtype = dtype

    def kernel(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The assembled (K, K, C) kernel and (C,) bias, K the largest window:
        each smaller window sits in the centre among zeros."""
        parts = []
        for conv in self.conv_list:
            k = conv.kernel_size[0]
            p = (self.max_k - k) // 2
            parts.append(F.pad(conv.weight[:, 0].permute(1, 2, 0), (0, 0, p, p, p, p)))
        w = torch.cat(parts, dim=-1).to(self.dtype).contiguous()
        b = torch.cat([conv.bias for conv in self.conv_list]).to(self.dtype)
        return w, b

    def forward(self, q: torch.Tensor, v: torch.Tensor,
                size: Tuple[int, int]) -> torch.Tensor:
        """q, v (B, N, C) tokens, possibly strided views → (B, N, C)."""
        w, b = self.kernel()
        q, v = q.to(self.dtype).unflatten(1, size), v.to(self.dtype).unflatten(1, size)
        ctx = current_context()
        if ctx is None:
            return dwconv.crpe_conv(q, v, w, b).flatten(1, 2)
        p = self.max_k // 2
        out = dwconv.crpe_conv(F.pad(q, (0, 0, 0, 0, p, p)),
                               halo_rows(v, p, ctx), w, b)
        return out[:, p:-p].flatten(1, 2)


class FactorAtt(nn.Module):
    """qkv → factorized attention + CRPE → Sup gate → proj
    (reference ``FactorAtt_ConvRelPosEnc_Sup``; without ``sup``,
    ``FactorAtt_ConvRelPosEnc``, no gate).

    The gate ``domain_layer`` (fc1 → ReLU → fc2, ``max(dim // 2, 4)`` hidden
    units) maps the one-hot domain to (heads, ch), softmaxed over heads in
    fp32, and multiplies the attention output before ``proj``."""

    def __init__(self, dim: int, num_heads: int, num_domains: int,
                 proj_drop: float = 0.0, sup: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.proj_drop = proj_drop
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.sup = sup
        if sup:
            hidden = max(dim // 2, 4)
            self.domain_layer = nn.Sequential(
                Linear(num_domains, hidden, dtype=dtype), nn.ReLU(),
                Linear(hidden, dim, dtype=dtype))

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                domain_onehot: torch.Tensor | None, crpe: ConvRelPosEnc,
                train: bool = False, gen: torch.Generator | None = None) -> torch.Tensor:
        b, _, c = x.shape
        h = self.num_heads
        ch = c // h
        qkv = self.qkv(x)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        ctx = current_context()
        if ctx is None:
            att = fa.factorized_attention(q, k, v, ch, ch ** -0.5)
        else:
            tokens = [r * size[1] for r in ctx.split(size[0])]
            att = fa.factorized_attention_cp(q, k, v, ch, ch ** -0.5, ctx.group, tokens)
        out = att + crpe(q, v, size)
        if self.sup:
            gate = self.domain_layer(domain_onehot.to(out.dtype))
            gate = torch.softmax(gate.reshape(b, h, ch).float(), dim=1)
            out = out * gate.reshape(b, 1, c).to(out.dtype)
        return fast_dropout(self.proj(out), self.proj_drop, train, gen)


class SerialBlock(nn.Module):
    """CPE → LN → FactorAtt → DropPath + → LN → MLP → DropPath +; the LNs
    are ``norm1``/``norm2``, or per domain ``norm1s``/``norm2s`` (DSN)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 num_domains: int, drop: float = 0.0, drop_path: float = 0.0,
                 sup: bool = True, dsn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dsn = dsn
        suffix = "s" if dsn else ""
        self.add_module("norm1" + suffix, make_ln(dim, num_domains, dsn))
        self.factoratt_crpe = FactorAtt(dim, num_heads, num_domains, drop, sup,
                                        dtype=dtype)
        self.add_module("norm2" + suffix, make_ln(dim, num_domains, dsn))
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype=dtype)
        self.drop_path = drop_path

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                domain_onehot: torch.Tensor | None, cpe: ConvPosEnc,
                crpe: ConvRelPosEnc, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        norm1, norm2 = ((self.norm1s, self.norm2s) if self.dsn
                        else (self.norm1, self.norm2))
        x = cpe(x, size)
        cur = self.factoratt_crpe(norm1(x, domain_onehot), size, domain_onehot, crpe,
                                  train, gen)
        x = x + drop_path(cur, self.drop_path, train, gen)
        cur = self.mlp(norm2(x, domain_onehot), train, gen)
        return x + drop_path(cur, self.drop_path, train, gen)


class MHSAStage(nn.Module):
    """Shared CPE and CRPE plus ``num_layers`` serial blocks, (B, N, C) → (B, N, C).

    Block i's stochastic depth is ``drop_path_list[i]`` when the list is
    given (MPViT's linear schedule), else ``drop_path``."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 mlp_ratio: float, num_domains: int, drop: float = 0.0,
                 drop_path: float = 0.0, sup: bool = True, dsn: bool = False,
                 dtype: torch.dtype = torch.float32,
                 drop_path_list: Sequence[float] | None = None):
        super().__init__()
        if drop_path_list is not None and len(drop_path_list) != num_layers:
            raise ValueError(f"drop_path_list has {len(drop_path_list)} rates for "
                             f"{num_layers} blocks")
        rates = list(drop_path_list) if drop_path_list is not None else [drop_path] * num_layers
        self.cpe = ConvPosEnc(dim, dtype=dtype)
        self.crpe = ConvRelPosEnc(dim // num_heads, num_heads, dtype=dtype)
        self.mhca_blks = nn.ModuleList(
            SerialBlock(dim, num_heads, mlp_ratio, num_domains, drop, rate,
                        sup, dsn, dtype=dtype)
            for rate in rates)

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                domain_onehot: torch.Tensor | None, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        for blk in self.mhca_blks:
            x = blk(x, size, domain_onehot, self.cpe, self.crpe, train, gen)
        return x
