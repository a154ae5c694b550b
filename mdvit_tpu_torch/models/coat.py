"""CoaT and CoaT-Lite, the co-scale conv-attentional classifiers
(``mdvit_tpu/models/coat.py``).

Four scales, each a patch embed (a strided conv and a LayerNorm), a cls
token prepended to its H·W image tokens, and ``serial_depths[i]`` serial
blocks. A serial block runs the scale's shared CPE (kernel B) on the image
rows and attention over all H·W + 1 rows (kernel A), plus the shared CRPE
(kernel C) on the image rows, with a zero cls row. CoaT adds
``parallel_depth`` parallel blocks over scales 2 to 4: each attends at each
scale with that scale's CPE and CRPE, mixes the three results by bilinear
resizes of their image rows (the cls rows pass through), and runs one MLP
shared by the scales. CoaT-Lite's head reads scale 4's normed cls token;
CoaT's a learnt mix of scales 2 to 4's (``agg_weight``, ``agg_bias``,
computed in fp32).

Tokens are (B, N, C) with N = H·W + 1; the CPE's and CRPE's image rows are
strided views of them (``x[:, 1:]``, and ``q[:, 1:]``, ``v[:, 1:]`` of the
qkv projection), which the kernels read in place. The modules keep the flax
names (``cpe{i}``, ``crpe{i}``, ``cls_token{i}``, ``patch_embed{i}``,
``patch_norm{i}``, ``serial{i}_{j}``, ``parallel_{j}``, ``norm{2,3,4}``,
``head``, ``agg_weight``, ``agg_bias``), so ``convert.from_jax_variables``
maps the JAX model's leaves by name; CoaT-Lite has no ``norm2``/``norm3``,
as the JAX model creates none.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.blocks import ConvPosEnc, ConvRelPosEnc
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import Conv2d, Linear, Mlp
from mdvit_tpu_torch.ops.norm import DomainLayerNorm
from mdvit_tpu_torch.ops.resize import resize_bilinear
from mdvit_tpu_torch.parallel.mesh import current_context, from_first

Size = Tuple[int, int]


def _lead() -> int:
    """The cls rows this rank's tokens start with: 1, but 0 on every ctx rank
    after the first under context parallelism (rank 0 holds the cls row)."""
    ctx = current_context()
    return 1 if ctx is None or ctx.index == 0 else 0


class FactorAttCls(nn.Module):
    """qkv → factorized attention over [cls; image] rows + CRPE of the image
    rows (a zero cls row) → proj."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, size: Size, crpe: ConvRelPosEnc) -> torch.Tensor:
        c = x.shape[2]
        ch = c // self.num_heads
        qkv = self.qkv(x)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        ctx = current_context()
        if ctx is None:
            att = fa.factorized_attention(q, k, v, ch, ch ** -0.5)
        else:  # the cls row counted once, in rank 0's partials
            tokens = [r * size[1] + (i == 0) for i, r in enumerate(ctx.split(size[0]))]
            att = fa.factorized_attention_cp(q, k, v, ch, ch ** -0.5, ctx.group, tokens)
        lead = _lead()
        crpe_img = crpe(q[:, lead:], v[:, lead:], size)
        return self.proj(att + F.pad(crpe_img, (0, 0, lead, 0)))


def _with_cpe(x: torch.Tensor, size: Size, cpe: ConvPosEnc) -> torch.Tensor:
    """The CPE of the image rows, the cls row passed through."""
    lead = _lead()
    if lead == 0:
        return cpe(x, size)
    return torch.cat([x[:, :lead], cpe(x[:, lead:], size)], dim=1)


class CoaTSerialBlock(nn.Module):
    """CPE of the image rows → LN → FactorAttCls + → LN → MLP +."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = DomainLayerNorm(dim)
        self.factoratt_crpe = FactorAttCls(dim, num_heads, dtype=dtype)
        self.norm2 = DomainLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x: torch.Tensor, size: Size, cpe: ConvPosEnc,
                crpe: ConvRelPosEnc) -> torch.Tensor:
        x = _with_cpe(x, size, cpe)
        x = x + self.factoratt_crpe(self.norm1(x), size, crpe)
        return x + self.mlp(self.norm2(x))


def _interp_tokens(x: torch.Tensor, size_in: Size, size_out: Size) -> torch.Tensor:
    """Bilinear resize of the image rows from ``size_in`` to ``size_out``,
    the cls row passed through (``coat.py:_interp_tokens``)."""
    b, _, c = x.shape
    lead = _lead()
    grid = resize_bilinear(x[:, lead:].reshape(b, size_in[0], size_in[1], c), size_out)
    return torch.cat([x[:, :lead], grid.reshape(b, size_out[0] * size_out[1], c)], dim=1)


class _ParallelBlockImpl(nn.Module):
    """A parallel block over scales 2 to 4 (``coat.py:_ParallelBlockImpl``):
    per scale s, CPE_s, LN ``norm1{s}``, attention ``factoratt_crpe{s}``
    with CRPE_s; the three attention outputs mixed across scales by
    ``_interp_tokens``; then LN ``norm2{s}`` and the shared ``mlp_shared``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for s in (2, 3, 4):
            self.add_module(f"norm1{s}", DomainLayerNorm(dim))
            self.add_module(f"factoratt_crpe{s}", FactorAttCls(dim, num_heads, dtype=dtype))
        self.mlp_shared = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        for s in (2, 3, 4):
            self.add_module(f"norm2{s}", DomainLayerNorm(dim))

    def forward(self, xs: Sequence[torch.Tensor], sizes: Sequence[Size],
                cpes: Sequence[ConvPosEnc], crpes: Sequence[ConvRelPosEnc]):
        x1, x2, x3, x4 = xs
        _, s2, s3, s4 = sizes

        def attend(x, size, idx):
            x = _with_cpe(x, size, cpes[idx])
            cur = getattr(self, f"factoratt_crpe{idx + 1}")(
                getattr(self, f"norm1{idx + 1}")(x), size, crpes[idx])
            return x, cur

        x2, cur2 = attend(x2, s2, 1)
        x3, cur3 = attend(x3, s3, 2)
        x4, cur4 = attend(x4, s4, 3)
        new2 = cur2 + _interp_tokens(cur3, s3, s2) + _interp_tokens(cur4, s4, s2)
        new3 = cur3 + _interp_tokens(cur4, s4, s3) + _interp_tokens(cur2, s2, s3)
        new4 = cur4 + _interp_tokens(cur3, s3, s4) + _interp_tokens(cur2, s2, s4)
        x2, x3, x4 = x2 + new2, x3 + new3, x4 + new4
        x2 = x2 + self.mlp_shared(self.norm22(x2))
        x3 = x3 + self.mlp_shared(self.norm23(x3))
        x4 = x4 + self.mlp_shared(self.norm24(x4))
        return x1, x2, x3, x4


class CoaT(nn.Module):
    """CoaT (``parallel_depth`` > 0) or CoaT-Lite classifier:
    ``{"logits": (B, num_classes), "feat": (B, C)}``.

    Under context parallelism (``parallel/context.py``) each scale's cls row
    lives on ctx rank 0, the other ranks hold image rows only: rank 0's
    attention partials count the cls row once, and the head reads the cls
    rows rank 0 sends to every rank (``from_first``)."""

    context_parallel_gap = None
    total_stride = 32  # the /4 patch embed, then /2 at scales 2 to 4
    # the row-changing ops (parallel/context.py): the patch embeds,
    # non-overlapping windows (⌊R/s⌋ rows, the last rows dropped)
    row_chain = (("tiled", 4),) + (("tiled", 2),) * 3

    def __init__(self, patch_size: int = 4, num_classes: int = 1000,
                 embed_dims: Sequence[int] = (64, 128, 256, 320),
                 serial_depths: Sequence[int] = (2, 2, 2, 2), parallel_depth: int = 0,
                 num_heads: int = 8, mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = tuple(embed_dims)
        self.serial_depths = tuple(serial_depths)
        self.parallel_depth = parallel_depth
        for i in range(1, 5):
            d = dims[i - 1]
            self.add_module(f"cpe{i}", ConvPosEnc(d, dtype=dtype))
            self.add_module(f"crpe{i}", ConvRelPosEnc(d // num_heads, num_heads, dtype=dtype))
            self.register_parameter(f"cls_token{i}", nn.Parameter(torch.zeros(1, 1, d)))
            k = patch_size if i == 1 else 2
            self.add_module(f"patch_embed{i}", Conv2d(3 if i == 1 else dims[i - 2], d, k, k,
                                                      dtype=dtype))
            self.add_module(f"patch_norm{i}", DomainLayerNorm(d))
            for j in range(self.serial_depths[i - 1]):
                self.add_module(f"serial{i}_{j}", CoaTSerialBlock(
                    d, num_heads, mlp_ratios[i - 1], dtype=dtype))
        for j in range(parallel_depth):
            self.add_module(f"parallel_{j}", _ParallelBlockImpl(
                dims[1], num_heads, mlp_ratios[1], dtype=dtype))
        if parallel_depth > 0:
            self.norm2 = DomainLayerNorm(dims[1])
            self.norm3 = DomainLayerNorm(dims[2])
        self.norm4 = DomainLayerNorm(dims[3])
        self.head = Linear(dims[3], num_classes, dtype=dtype)
        if parallel_depth > 0:
            # Conv1d(3 → 1, k = 1) over the stacked per-scale cls tokens
            self.agg_weight = nn.Parameter(torch.zeros(3))
            self.agg_bias = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        """The cls tokens and ``agg_weight`` normal(0, 0.02), as JAX draws them."""
        names = [f"cls_token{i}" for i in range(1, 5)]
        names += ["agg_weight"] if self.parallel_depth > 0 else []
        for name in names:
            p = getattr(self, name)
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, gen: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x (B, H, W, 3) normalised images; ``domain_onehot``, ``train`` and
        ``gen`` are the JAX module's signature (CoaT has no dropout, no
        stochastic depth and no BatchNorm)."""
        b, lead = x.shape[0], _lead()
        cpes = [getattr(self, f"cpe{i}") for i in range(1, 5)]
        crpes = [getattr(self, f"crpe{i}") for i in range(1, 5)]
        tokens, sizes, cur = [], [], x
        for i in range(1, 5):
            grid = getattr(self, f"patch_embed{i}")(cur)
            h, w = grid.shape[1], grid.shape[2]
            t = getattr(self, f"patch_norm{i}")(grid.reshape(b, h * w, -1))
            if lead:
                cls_tok = getattr(self, f"cls_token{i}").to(t.dtype).expand(b, 1, t.shape[2])
                t = torch.cat([cls_tok, t], dim=1)
            for j in range(self.serial_depths[i - 1]):
                t = getattr(self, f"serial{i}_{j}")(t, (h, w), cpes[i - 1], crpes[i - 1])
            tokens.append(t)
            sizes.append((h, w))
            cur = t[:, lead:].reshape(b, h, w, -1)
        if self.parallel_depth == 0:
            cls4 = from_first(self.norm4(tokens[3])[:, 0])
            return {"logits": self.head(cls4), "feat": cls4}
        xs = tuple(tokens)
        for j in range(self.parallel_depth):
            xs = getattr(self, f"parallel_{j}")(xs, sizes, cpes, crpes)
        stacked = from_first(torch.cat([self.norm2(xs[1])[:, :1], self.norm3(xs[2])[:, :1],
                                        self.norm4(xs[3])[:, :1]], dim=1))  # (B, 3, C)
        merged = torch.einsum("bsc,s->bc", stacked.float(), self.agg_weight.float()) \
            + self.agg_bias
        return {"logits": self.head(merged.to(stacked.dtype)), "feat": merged}


# the JAX builders' configurations (``coat.py:_coat_factory`` calls)
CONFIGS = {
    "coat_tiny": dict(embed_dims=(152, 152, 152, 152), serial_depths=(2, 2, 2, 2),
                      parallel_depth=6, mlp_ratios=(4, 4, 4, 4)),
    "coat_mini": dict(embed_dims=(152, 216, 216, 216), serial_depths=(2, 2, 2, 2),
                      parallel_depth=6, mlp_ratios=(4, 4, 4, 4)),
    "coat_small": dict(embed_dims=(152, 320, 320, 320), serial_depths=(2, 2, 2, 2),
                       parallel_depth=6, mlp_ratios=(4, 4, 4, 4)),
    "coat_lite_tiny": dict(embed_dims=(64, 128, 256, 320), serial_depths=(2, 2, 2, 2),
                           parallel_depth=0, mlp_ratios=(8, 8, 4, 4)),
    "coat_lite_mini": dict(embed_dims=(64, 128, 320, 512), serial_depths=(2, 2, 2, 2),
                           parallel_depth=0, mlp_ratios=(8, 8, 4, 4)),
    "coat_lite_small": dict(embed_dims=(64, 128, 320, 512), serial_depths=(3, 4, 6, 3),
                            parallel_depth=0, mlp_ratios=(8, 8, 4, 4)),
}
