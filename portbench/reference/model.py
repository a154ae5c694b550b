"""MDViT and BASE in plain PyTorch, fp32, NHWC: the published architecture
(siyi-wind/MDViT ``Models/Transformer/mdvit.py`` and ``base.py``) without
any kernel of the system under test, for the benchmark's output check.

Factorized attention is softmax-over-tokens, KᵀV and Q·(KᵀV) as einsums;
the convolutional position encodings are depthwise ``F.conv2d`` calls (CRPE
as its three windows 3/5/7 over 2/3/3 heads); the resizes are
``F.interpolate``. Parameter and buffer names are the system's
``state_dict`` names, so one state dict loads into both.

Train-mode BatchNorms of the trunk normalise each domain's samples with
that domain's batch moments; the debranches' with their group's. A forward
runs on a block of rows that is one or more whole domains of the batch
(``row0`` its first row), so a step can be computed a domain at a time:
nothing couples two domains' rows. Dropout seeds come from a ``SeedTape``.
Running statistics are not updated in train mode (nothing compared reads
them); ``calibrate`` sets them to a batch's moments (the serving weights).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import rng

BN_EPS, LN_EPS = 1e-5, 1e-6
CRPE_WINDOWS = {3: 2, 5: 3, 7: 3}


class Ctx:
    """What a train-mode forward needs beyond its inputs: the seed tape,
    the block's first row in the batch, the dropout rates; ``calibrate``
    makes BatchNorms store the batch's moments."""

    def __init__(self, tape: rng.SeedTape | None = None, row0: int = 0,
                 drop: float = 0.0, drop_path: float = 0.0, calibrate: bool = False):
        self.tape, self.row0, self.drop, self.drop_path = tape, row0, drop, drop_path
        self.calibrate = calibrate

    @property
    def train(self) -> bool:
        return self.tape is not None or self.calibrate


def conv(x: torch.Tensor, m: nn.Conv2d) -> torch.Tensor:
    """``m`` on NHWC ``x``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), m.weight, m.bias, m.stride, m.padding, m.dilation,
                 m.groups)
    return y.permute(0, 2, 3, 1)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


class BN(nn.Module):
    """BatchNorm over the last axis: per-domain moments (``domains`` > 1,
    the sample's one-hot picks its group) or the block's moments. The
    moments are taken as the system specifies them (the JAX package's
    ``norm.py``): the mean and E[x²] in one pass, var = E[x²] − mean²; a
    two-pass variance differs from it by more than fp32 rounding where a
    channel's mean dwarfs its spread."""

    def __init__(self, c: int, domains: int = 1):
        super().__init__()
        self.domains = domains
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, onehot: torch.Tensor | None, ctx: Ctx) -> torch.Tensor:
        if not ctx.train:
            return (x - self.running_mean) / torch.sqrt(self.running_var + BN_EPS) * self.weight \
                + self.bias
        spatial = tuple(range(1, x.dim() - 1))
        if ctx.calibrate or self.domains == 1:
            oh = torch.ones((x.shape[0], 1), device=x.device)
        else:
            oh = onehot.float()                                   # (B, D)
        n = oh.sum(0).clamp(min=1.0)[:, None] * (x.numel() // (x.shape[0] * x.shape[-1]))
        # the system's moments: var = E[x²] − mean², clamped at 0 (one pass)
        mean = (oh.t() @ x.sum(dim=spatial)) / n                  # (D, C)
        var = ((oh.t() @ (x * x).sum(dim=spatial)) / n - mean * mean).clamp(min=0.0)
        if ctx.calibrate:
            self.running_mean.copy_(mean[0])
            self.running_var.copy_(var[0] * n[0] / (n[0] - 1).clamp(min=1.0))
        shape = (x.shape[0], *[1] * len(spatial), x.shape[-1])
        y = (x - (oh @ mean).reshape(shape)) / torch.sqrt((oh @ var).reshape(shape) + BN_EPS)
        return y * self.weight + self.bias


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, LN_EPS)


class ConvBN(nn.Module):
    """conv (no bias) → BN → hardswish (the stems)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, pad: int, domains: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, pad, bias=False)
        self.bn = BN(cout, domains)

    def forward(self, x, onehot, ctx):
        return F.hardswish(self.bn(conv(x, self.conv), onehot, ctx))


class DWConvBN(nn.Module):
    """depthwise (``groups`` = cin for the patch embeds, cout for the
    decoders' 2C → C conv) → pointwise → BN → hardswish."""

    def __init__(self, cin: int, cout: int, stride: int, groups_on_in: bool, domains: int):
        super().__init__()
        mid = cin if groups_on_in else cout
        self.dwconv = nn.Conv2d(cin, mid, 3, stride, 1, groups=mid, bias=False)
        self.pwconv = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn = BN(cout, domains)

    def forward(self, x, onehot, ctx):
        return F.hardswish(self.bn(conv(conv(x, self.dwconv), self.pwconv), onehot, ctx))


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, domains: int):
        super().__init__()
        self.patch_conv = DWConvBN(cin, cout, stride, True, domains)

    def forward(self, x, onehot, ctx):
        return self.patch_conv(x, onehot, ctx)


class CPE(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        grid = x.unflatten(1, size)
        return (conv(grid, self.proj) + grid).flatten(1, 2)


class CRPE(nn.Module):
    def __init__(self, ch: int, heads: int):
        super().__init__()
        assert sum(CRPE_WINDOWS.values()) == heads
        self.splits = [n * ch for n in CRPE_WINDOWS.values()]
        self.conv_list = nn.ModuleList(nn.Conv2d(c, c, k, padding=k // 2, groups=c)
                                       for k, c in zip(CRPE_WINDOWS, self.splits))

    def forward(self, q: torch.Tensor, v: torch.Tensor, size) -> torch.Tensor:
        parts = torch.split(v.unflatten(1, size), self.splits, dim=-1)
        conv_v = torch.cat([conv(p, m) for p, m in zip(parts, self.conv_list)], dim=-1)
        return q * conv_v.flatten(1, 2)


class FactorAtt(nn.Module):
    def __init__(self, dim: int, heads: int, domains: int, sup: bool):
        super().__init__()
        self.heads, self.sup = heads, sup
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if sup:
            self.domain_layer = nn.Sequential(nn.Linear(domains, max(dim // 2, 4)), nn.ReLU(),
                                              nn.Linear(max(dim // 2, 4), dim))

    def forward(self, x, size, onehot, crpe: CRPE, ctx: Ctx):
        b, n, c = x.shape
        h, ch = self.heads, c // self.heads
        q, k, v = self.qkv(x).split(c, dim=-1)
        ks = torch.softmax(k.reshape(b, n, h, ch), dim=1)
        ktv = torch.einsum("bnhk,bnhv->bhkv", ks, v.reshape(b, n, h, ch))
        att = torch.einsum("bnhk,bhkv->bnhv", q.reshape(b, n, h, ch), ktv).reshape(b, n, c)
        out = ch ** -0.5 * att + crpe(q, v, size)
        if self.sup:
            gate = torch.softmax(self.domain_layer(onehot).reshape(b, h, ch), dim=1)
            out = out * gate.reshape(b, 1, c)
        out = self.proj(out)
        return _dropout(out, ctx)


def _dropout(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Element dropout at the block's rate; a zero rate draws no seed."""
    return rng.dropout(x, ctx.drop, ctx.tape.next(), ctx.row0) if ctx.tape and ctx.drop else x


def _drop_path(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    if ctx.tape and ctx.drop_path:
        return rng.drop_path(x, ctx.drop_path, ctx.tape.next(), ctx.row0)
    return x


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x, ctx: Ctx):
        return _dropout(self.fc2(_dropout(F.gelu(self.fc1(x)), ctx)), ctx)


class Block(nn.Module):
    """CPE → LN → factorized attention + CRPE (Sup gate) → drop path + →
    LN → MLP → drop path +."""

    def __init__(self, dim, heads, mlp_ratio, domains, sup):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.factoratt_crpe = FactorAtt(dim, heads, domains, sup)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, size, onehot, cpe, crpe, ctx: Ctx):
        x = cpe(x, size)
        x = x + _drop_path(self.factoratt_crpe(layer_norm(x, self.norm1), size, onehot, crpe,
                                               ctx), ctx)
        return x + _drop_path(self.mlp(layer_norm(x, self.norm2), ctx), ctx)


class Stage(nn.Module):
    def __init__(self, dim, layers, heads, mlp_ratio, domains, sup):
        super().__init__()
        self.cpe = CPE(dim)
        self.crpe = CRPE(dim // heads, heads)
        self.mhca_blks = nn.ModuleList(Block(dim, heads, mlp_ratio, domains, sup)
                                       for _ in range(layers))

    def forward(self, x, size, onehot, ctx):
        for blk in self.mhca_blks:
            x = blk(x, size, onehot, self.cpe, self.crpe, ctx)
        return x


class DecoderBlock(nn.Module):
    """1×1 conv → resize to the skip → concat(skip, ·) → grouped 2C → C
    DWConvBN → attention stage."""

    def __init__(self, cin, cout, stage: Stage, domains):
        super().__init__()
        self.conv_before = nn.Conv2d(cin, cout, 1)
        self.conv_after = DWConvBN(2 * cout, cout, 1, False, domains)
        self.mhsa_block = stage

    def forward(self, x, skip, onehot, ctx):
        size = tuple(skip.shape[1:3])
        out = torch.cat([skip, resize(conv(x, self.conv_before), size)], dim=-1)
        out = self.conv_after(out, onehot, ctx)
        return self.mhsa_block(out.flatten(1, 2), size, onehot, ctx).unflatten(1, size)


class MLPDecoderFM(nn.Module):
    """MDViT's debranch: 1×1 convs of the four scales to 512, resized to
    H/4, concat with the H/4 decoder feature, 1×1 conv, BN, ReLU,
    channel dropout, 1×1 conv to one channel, resized to the image."""

    def __init__(self, dims: Sequence[int], img: int, hidden: int = 512):
        super().__init__()
        for i, c in enumerate(dims):
            self.add_module(f"linear{i + 1}", nn.Conv2d(c, hidden, 1))
        self.linear_fuse = nn.ModuleList([nn.Conv2d(len(dims) * hidden + dims[0], hidden, 1),
                                          BN(hidden)])
        self.linear_out = nn.Conv2d(hidden, 1, 1)
        self.img = img

    def forward(self, feats, ctx: Ctx, seed: int | None):
        size = tuple(feats[0].shape[1:3])
        outs = [resize(conv(f, getattr(self, f"linear{i + 1}")), size)
                for i, f in enumerate(feats[:4])]
        out = conv(torch.cat([*outs, feats[4]], dim=-1), self.linear_fuse[0])
        out = F.relu(self.linear_fuse[1](out, None, ctx))
        if seed is not None:
            # a debranch's rows are counted from its own group's first row
            out = rng.dropout2d(out, 0.1, seed, 0)
        return resize(conv(out, self.linear_out), (self.img, self.img))


class Model(nn.Module):
    """``kind`` "mdvit" (Sup gate, MLPFM debranches) or "base"."""

    def __init__(self, kind: str, img: int, embed_dims=(64, 128, 320, 512),
                 num_layers=(2, 2, 2, 2), mlp_ratios=(8, 8, 4, 4), num_heads=(8, 8, 8, 8),
                 domains: int = 4):
        super().__init__()
        self.kind, self.domains = kind, domains
        dims = tuple(embed_dims)
        sup = kind == "mdvit"
        self.stem = nn.ModuleList([ConvBN(3, dims[0] // 2, 3, 2, 1, domains),
                                   ConvBN(dims[0] // 2, dims[0], 3, 2, 1, domains)])
        self.patch_embed_stages = nn.ModuleList(
            PatchEmbed(dims[max(i - 1, 0)], dims[i], 1 if i == 0 else 2, domains)
            for i in range(4))

        def stage(i):
            return Stage(dims[i], num_layers[i], num_heads[i], mlp_ratios[i], domains, sup)

        self.mhsa_stages = nn.ModuleList(stage(i) for i in range(4))
        self.bridge = nn.Sequential(nn.Conv2d(dims[3], dims[3], 3, 1, 1), BN(dims[3], domains),
                                    nn.ReLU(), nn.Conv2d(dims[3], 2 * dims[3], 3, 1, 1),
                                    BN(2 * dims[3], domains), nn.ReLU())
        in_chs = (2 * dims[3],) + dims[:0:-1]
        for n in range(1, 5):
            self.add_module(f"decoder{n}", DecoderBlock(in_chs[n - 1], dims[4 - n],
                                                        stage(4 - n), domains))
        self.finalconv = nn.Sequential(nn.Conv2d(dims[0], 1, 1))
        if sup:
            for d in range(1, domains + 1):
                self.add_module(f"debranch{d}", MLPDecoderFM(dims, img))

    def forward(self, x: torch.Tensor, onehot: torch.Tensor, ctx: Ctx, domain: int | None = None):
        """(logits (B, H, W, 1), aux logits or None) of normalised NHWC
        ``x``. ``domain``: the block is that domain's group (train), and the
        MDViT debranch of that domain runs on it."""
        hw = tuple(x.shape[1:3])
        for m in self.stem:
            x = m(x, onehot, ctx)
        skips = []
        for embed, stage in zip(self.patch_embed_stages, self.mhsa_stages):
            x = embed(x, onehot, ctx)
            size = tuple(x.shape[1:3])
            x = stage(x.flatten(1, 2), size, onehot, ctx).unflatten(1, size)
            skips.append(x)
        c1, b1, _, c2, b2, _ = self.bridge
        out = F.relu(b1(conv(skips[3], c1), onehot, ctx))
        out = F.relu(b2(conv(out, c2), onehot, ctx))
        for n in range(1, 5):
            out = getattr(self, f"decoder{n}")(out, skips[4 - n], onehot, ctx)
        logits = resize(conv(out, self.finalconv[0]), hw)
        if self.kind != "mdvit" or domain is None:
            return logits, None
        seed = ctx.tape.at(ctx.tape.pos + domain) if ctx.tape else None
        aux = getattr(self, f"debranch{domain + 1}")([*skips, out], ctx, seed)
        return logits, aux
