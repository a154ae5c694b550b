"""TransFuse_S / _S_adapt / _L / _L_384 (``mdvit_tpu/models/transfuse.py``):
a torchvision-layout ResNet34/50 (through layer3) beside a DeiT
(small: embed 384, depth 8, heads 6; base: 768, 12, 12), fused at each scale
by ``BiFusion`` (channel attention on the transformer branch, spatial
attention on the CNN branch, bilinear pooling), attention-gated ``UpBlock``
merges and three output heads. ``TransFuse_S_adapt`` puts the Sup domain gate
in every DeiT attention block. The token grid is ``img_size // 16``;
``TransFuse_L_384`` is pinned to 384×512, a (24, 32) grid.

The forward returns ``{"seg": (map_x, map_1, map_2), "feat"}``, three
full-resolution maps (align-corners upsampled) for the deep-supervision
loss; eval and serving take map_2 (``models.base.split_seg``). Attention is
explicit products and a softmax in fp32; nothing here reaches the port's
kernels. Submodules keep the flax names (``transformer.block{i}_attn``,
``resnet.layer{l}_{b}``, ``up_c_1_1``, ``final_x_0``, ...).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.swin_unet import attend, require_no_aux, scores
from mdvit_tpu_torch.ops.layers import Conv2d, Linear, Mlp, dropout2d, fast_dropout
from mdvit_tpu_torch.ops.norm import DomainBatchNorm, DomainLayerNorm
from mdvit_tpu_torch.ops.resize import resize_bilinear_align_corners

# variant → (ResNet, DeiT embed, depth, heads, ResNet layer widths, UpBlock widths,
# head width)
VARIANTS = {"S": ("resnet34", 384, 8, 6, (64, 128, 256), (128, 64), 64),
            "L": ("resnet50", 768, 12, 12, (256, 512, 1024), (512, 256), 256)}


def _pair(size) -> tuple[int, int]:
    """(H, W) of an int or a 2-sequence."""
    if isinstance(size, int):
        return (size, size)
    h, w = size
    return (int(h), int(w))


# ------------------------------------------------------------ ResNet branch


class ResNetBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = DomainBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = DomainBatchNorm(planes)
        self.down = stride != 1 or in_ch != planes
        if self.down:
            self.down_conv = Conv2d(in_ch, planes, 1, stride, 0, bias=False, dtype=dtype)
            self.down_bn = DomainBatchNorm(planes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), None, train))
        out = self.bn2(self.conv2(out), None, train)
        if self.down:
            x = self.down_bn(self.down_conv(x), None, train)
        return F.relu(out + x)


class ResNetBottleneck(nn.Module):
    """Bottleneck of width ``planes``; its output is 4·planes."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = 4 * planes
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False, dtype=dtype)
        self.bn1 = DomainBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn2 = DomainBatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = DomainBatchNorm(out_ch)
        self.down = stride != 1 or in_ch != out_ch
        if self.down:
            self.down_conv = Conv2d(in_ch, out_ch, 1, stride, 0, bias=False, dtype=dtype)
            self.down_bn = DomainBatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), None, train))
        out = F.relu(self.bn2(self.conv2(out), None, train))
        out = self.bn3(self.conv3(out), None, train)
        if self.down:
            x = self.down_bn(self.down_conv(x), None, train)
        return F.relu(out + x)


class ResNetStem3Stages(nn.Module):
    """torchvision resnet34 or resnet50 through layer3 (3, 4, 6 blocks of
    widths 64, 128, 256): the (layer1, layer2, layer3) features."""

    def __init__(self, arch: str = "resnet34", dtype: torch.dtype = torch.float32):
        super().__init__()
        block = ResNetBasicBlock if arch == "resnet34" else ResNetBottleneck
        self.blocks = (3, 4, 6)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = DomainBatchNorm(64)
        cin = 64
        for li, (n, w) in enumerate(zip(self.blocks, (64, 128, 256))):
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                self.add_module(f"layer{li + 1}_{bi}", block(cin, w, stride, dtype))
                cin = w * block.expansion

    def forward(self, x: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x), None, train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for li, n in enumerate(self.blocks):
            for bi in range(n):
                x = getattr(self, f"layer{li + 1}_{bi}")(x, train)
            outs.append(x)
        return outs


# -------------------------------------------------------------- DeiT branch


class ViTAttention(nn.Module):
    """Multi-head self attention; ``sup`` adds the Sup domain gate before the
    output projection: a softmax over heads of fc2(relu(fc1(onehot)))."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, sup: bool = False,
                 num_domains: int = 4, drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.sup, self.drop = num_heads, sup, drop
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        if sup:
            hidden = max(dim // 2, 4)
            self.domain_layer_fc1 = Linear(num_domains, hidden, dtype=dtype)
            self.domain_layer_fc2 = Linear(hidden, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, gen=None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(scores(qkv[0], qkv[1]) * (c // h) ** -0.5, dim=-1)
        out = attend(attn, qkv[2], x.dtype)                      # (b, h, n, ch)
        if self.sup:
            g = F.relu(self.domain_layer_fc1(domain_onehot.to(out.dtype)))
            g = self.domain_layer_fc2(g).reshape(b, h, c // h)
            g = torch.softmax(g.float(), dim=1).to(out.dtype)
            out = out * g[:, :, None, :]
        out = self.proj(out.transpose(1, 2).reshape(b, n, c))
        return fast_dropout(out, self.drop, train, gen)


class DeiT(nn.Module):
    """ViT encoder, no cls token in use: a 16×16 patch conv, a position
    embedding over the actual token grid, pre-LN blocks, a final LN; returns
    the tokens (B, N, C)."""

    def __init__(self, img_size: int | Sequence[int] = 256, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 8, num_heads: int = 6,
                 mlp_ratio: float = 4.0, sup: bool = False, num_domains: int = 4,
                 drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        ih, iw = _pair(img_size)
        self.grid = (ih // patch_size, iw // patch_size)
        self.depth, self.drop = depth, drop
        self.patch_embed = Conv2d(3, embed_dim, patch_size, patch_size, 0, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid[0] * self.grid[1], embed_dim))
        for i in range(depth):
            self.add_module(f"block{i}_norm1", DomainLayerNorm(embed_dim))
            self.add_module(f"block{i}_attn", ViTAttention(
                embed_dim, num_heads, sup=sup, num_domains=num_domains, drop=drop,
                dtype=dtype))
            self.add_module(f"block{i}_norm2", DomainLayerNorm(embed_dim))
            self.add_module(f"block{i}_mlp", Mlp(embed_dim, int(embed_dim * mlp_ratio), drop,
                                                 dtype=dtype))
        self.norm = DomainLayerNorm(embed_dim)

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape, generator=generator))

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, gen=None) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x.reshape(x.shape[0], self.grid[0] * self.grid[1], -1)
        x = fast_dropout(x + self.pos_embed.to(x.dtype), self.drop, train, gen)
        for i in range(self.depth):
            cur = getattr(self, f"block{i}_norm1")(x)
            x = x + getattr(self, f"block{i}_attn")(cur, domain_onehot, train, gen)
            cur = getattr(self, f"block{i}_norm2")(x)
            x = x + getattr(self, f"block{i}_mlp")(cur, train, gen)
        return self.norm(x)


# -------------------------------------------------------- fusion / decoder


class ConvBnRelu(nn.Module):
    """conv (+ BN) (+ ReLU), ``kernel``² with same padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bn: bool = False,
                 relu: bool = True, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, 1, (kernel - 1) // 2, bias=bias,
                           dtype=dtype)
        self.bn = DomainBatchNorm(out_ch) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, None, train)
        return F.relu(x) if self.relu else x


class Residual(nn.Module):
    """Pre-activation bottleneck residual: BN → ReLU → 1×1 → BN → ReLU → 3×3 →
    BN → ReLU → 1×1, plus a 1×1 skip when the width changes."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        half = out_ch // 2
        self.skip_layer = (ConvBnRelu(in_ch, out_ch, 1, relu=False, dtype=dtype)
                           if in_ch != out_ch else None)
        self.bn1 = DomainBatchNorm(in_ch)
        self.conv1 = ConvBnRelu(in_ch, half, 1, relu=False, dtype=dtype)
        self.bn2 = DomainBatchNorm(half)
        self.conv2 = ConvBnRelu(half, half, 3, relu=False, dtype=dtype)
        self.bn3 = DomainBatchNorm(half)
        self.conv3 = ConvBnRelu(half, out_ch, 1, relu=False, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        residual = x if self.skip_layer is None else self.skip_layer(x, train)
        out = self.conv1(F.relu(self.bn1(x, None, train)), train)
        out = self.conv2(F.relu(self.bn2(out, None, train)), train)
        out = self.conv3(F.relu(self.bn3(out, None, train)), train)
        return out + residual


class BiFusion(nn.Module):
    """Bilinear pooling and dual attention fusion of g (the CNN branch,
    ``ch_1`` channels) and x (the transformer branch, ``ch_2``)."""

    def __init__(self, ch_1: int, ch_2: int, r_2: int, ch_int: int, ch_out: int,
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_rate = drop_rate
        self.W_g = ConvBnRelu(ch_1, ch_int, 1, bn=True, relu=False, dtype=dtype)
        self.W_x = ConvBnRelu(ch_2, ch_int, 1, bn=True, relu=False, dtype=dtype)
        self.W = ConvBnRelu(ch_int, ch_int, 3, bn=True, relu=True, dtype=dtype)
        self.spatial = ConvBnRelu(2, 1, 7, bn=True, relu=False, bias=False, dtype=dtype)
        self.fc1 = Conv2d(ch_2, ch_2 // r_2, 1, dtype=dtype)
        self.fc2 = Conv2d(ch_2 // r_2, ch_2, 1, dtype=dtype)
        self.residual = Residual(ch_1 + ch_2 + ch_int, ch_out, dtype)

    def forward(self, g: torch.Tensor, x: torch.Tensor, train: bool = False,
                gen=None) -> torch.Tensor:
        bp = self.W(self.W_g(g, train) * self.W_x(x, train), train)
        pooled = torch.cat([g.amax(dim=-1, keepdim=True), g.mean(dim=-1, keepdim=True)], -1)
        g = torch.sigmoid(self.spatial(pooled, train)) * g
        ca = self.fc2(F.relu(self.fc1(x.mean(dim=(1, 2), keepdim=True))))
        x = torch.sigmoid(ca) * x
        fuse = self.residual(torch.cat([g, x, bp], dim=-1), train)
        return dropout2d(fuse, self.drop_rate, train, gen)


class AttentionGate(nn.Module):
    """Additive attention gate: x · σ(psi(relu(W_g·g + W_x·x)))."""

    def __init__(self, g_ch: int, x_ch: int, f_int: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.W_g = ConvBnRelu(g_ch, f_int, 1, bn=True, relu=False, dtype=dtype)
        self.W_x = ConvBnRelu(x_ch, f_int, 1, bn=True, relu=False, dtype=dtype)
        self.psi = ConvBnRelu(f_int, 1, 1, bn=True, relu=False, dtype=dtype)

    def forward(self, g: torch.Tensor, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        psi = self.psi(F.relu(self.W_g(g, train) + self.W_x(x, train)), train)
        return x * torch.sigmoid(psi)


class UpBlock(nn.Module):
    """×2 bilinear (align-corners) upsample of x1, the gated skip x2 (when
    given) concatenated before it, then a double conv with a 1×1 identity
    branch."""

    def __init__(self, in_ch: int, out_ch: int, skip_ch: int = 0, attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn:
            self.attn_block = AttentionGate(in_ch, skip_ch, out_ch, dtype)
        cat = in_ch + skip_ch
        self.dc_conv1 = Conv2d(cat, out_ch, 3, 1, 1, dtype=dtype)
        self.dc_bn1 = DomainBatchNorm(out_ch)
        self.dc_conv2 = Conv2d(out_ch, out_ch, 3, 1, 1, dtype=dtype)
        self.dc_bn2 = DomainBatchNorm(out_ch)
        self.id_conv = Conv2d(cat, out_ch, 1, dtype=dtype)
        self.id_bn = DomainBatchNorm(out_ch)
        self.attn = attn

    def forward(self, x1: torch.Tensor, x2: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        x1 = resize_bilinear_align_corners(x1, (x1.shape[1] * 2, x1.shape[2] * 2))
        if x2 is not None:
            if self.attn:
                x2 = self.attn_block(x1, x2, train)
            x1 = torch.cat([x2, x1], dim=-1)
        dc = F.relu(self.dc_bn1(self.dc_conv1(x1), None, train))
        dc = self.dc_bn2(self.dc_conv2(dc), None, train)
        return F.relu(dc + self.id_bn(self.id_conv(x1), None, train))


class TransFuse(nn.Module):
    """TransFuse_S/_L (± the Sup gate): the three deep-supervision maps
    ``(map_x, map_1, map_2)``, NHWC logits at the input's size."""

    def __init__(self, img_size: int | Sequence[int] = 256, num_classes: int = 1,
                 variant: str = "S", sup: bool = False, num_domains: int = 4,
                 drop_rate: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        arch, ed, depth, heads, (c1, c2, c3), (u1, u2), mid = VARIANTS[variant]
        self.img_size = _pair(img_size)
        self.embed_dim, self.drop_rate = ed, drop_rate
        self.transformer = DeiT(self.img_size, embed_dim=ed, depth=depth, num_heads=heads,
                                sup=sup, num_domains=num_domains, dtype=dtype)
        self.up1 = UpBlock(ed, u1, dtype=dtype)
        self.up2 = UpBlock(u1, u2, dtype=dtype)
        self.resnet = ResNetStem3Stages(arch, dtype)
        half = drop_rate / 2
        self.up_c = BiFusion(c3, ed, 4, c3, c3, half, dtype)
        self.up_c_1_1 = BiFusion(c2, u1, 2, c2, c2, half, dtype)
        self.up_c_1_2 = UpBlock(c3, u1, c2, attn=True, dtype=dtype)
        self.up_c_2_1 = BiFusion(c1, u2, 1, c1, c1, half, dtype)
        self.up_c_2_2 = UpBlock(u1, u2, c1, attn=True, dtype=dtype)
        for name, cin, first in (("final_x", c3, True), ("final_1", u2, False),
                                 ("final_2", u2, False)):
            if first:
                self.add_module(f"{name}_0", ConvBnRelu(cin, mid, 1, bn=True, dtype=dtype))
                cin = mid
            self.add_module(f"{name}_1", ConvBnRelu(cin, mid, 3, bn=True, dtype=dtype))
            self.add_module(f"{name}_2", ConvBnRelu(mid, num_classes, 3, relu=False,
                                                    dtype=dtype))

    def _head(self, t: torch.Tensor, name: str, train: bool) -> torch.Tensor:
        if hasattr(self, f"{name}_0"):
            t = getattr(self, f"{name}_0")(t, train)
        t = getattr(self, f"{name}_1")(t, train)
        return resize_bilinear_align_corners(getattr(self, f"{name}_2")(t, train),
                                             self.img_size)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, out_feat: bool = True, out_seg: bool = True,
                aux_mode: str = "none", gen: torch.Generator | None = None
                ) -> dict[str, Any]:
        """``{"seg": (map_x, map_1, map_2), "feat": (B, c3)}``, ``feat`` the
        spatial mean of the deepest fusion. ``out_seg`` False skips the
        heads (the fusion they read still runs: ``feat`` is its mean)."""
        require_no_aux(aux_mode)
        gh, gw = self.transformer.grid

        def drop(t: torch.Tensor) -> torch.Tensor:
            return dropout2d(t, self.drop_rate, train, gen)

        tokens = self.transformer(x, domain_onehot, train, gen)
        x_b = drop(tokens.reshape(x.shape[0], gh, gw, self.embed_dim))
        x_b_1 = drop(self.up1(x_b, None, train))
        x_b_2 = drop(self.up2(x_b_1, None, train))
        x_u_2, x_u_1, x_u = (drop(f) for f in self.resnet(x, train))
        x_c = self.up_c(x_u, x_b, train, gen)
        feat = x_c.mean(dim=(1, 2)) if out_feat else None
        if not out_seg:
            return {"seg": None, "feat": feat}
        x_c_1 = self.up_c_1_2(x_c, self.up_c_1_1(x_u_1, x_b_1, train, gen), train)
        x_c_2 = self.up_c_2_2(x_c_1, self.up_c_2_1(x_u_2, x_b_2, train, gen), train)
        maps = (self._head(x_c, "final_x", train), self._head(x_b_2, "final_1", train),
                self._head(x_c_2, "final_2", train))
        return {"seg": maps, "feat": feat}
