"""UTNet (``mdvit_tpu/models/utnet.py``): hybrid CNN/transformer U-Net.

Pre-activation residual conv blocks, transformer blocks whose K and V are
resized (bilinear, align-corners) to ``reduce_size``² before a full softmax
attention, cross-attention decoder blocks (q from the high-resolution
input, k and v from the low-resolution one) and a 2-D relative position
bias over reduce_size², repeated up to the query grid. The trainer's
wiring: base_chan 32, block_list '1234', one block a stage, 4 heads,
reduce_size 8, attention and projection dropout 0.1, max-pool down.

The "linear attention" is softmax attention over the reduced K and V,
computed as explicit products in fp32 (``swin_unet.scores``/``attend``); it
is not factorized attention and reaches no kernel of the port. Its bias is
``table[index]`` with a broadcast repeat (whose backward is a sum, not
``repeat_interleave``'s scatter). Submodules keep the flax names.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.swin_unet import attend, relative_bias, require_no_aux, scores
from mdvit_tpu_torch.ops.layers import Conv2d, fast_dropout
from mdvit_tpu_torch.ops.norm import DomainBatchNorm
from mdvit_tpu_torch.ops.resize import resize_bilinear_align_corners


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max pool of NHWC ``x`` (JAX's ``reduce_window`` max)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class DWSepConv(nn.Module):
    """Depthwise ``kernel``² conv → pointwise conv, both without bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise = Conv2d(in_ch, in_ch, kernel, 1, (kernel - 1) // 2, groups=in_ch,
                                bias=False, dtype=dtype)
        self.pointwise = Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class BasicBlock(nn.Module):
    """Pre-activation residual block (BN → ReLU → conv, twice), with a
    BN → ReLU → 1×1 conv shortcut when the stride or the width changes."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = DomainBatchNorm(in_ch)
        self.conv1 = Conv2d(in_ch, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn2 = DomainBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.shortcut = stride != 1 or in_ch != planes
        if self.shortcut:
            self.shortcut_bn = DomainBatchNorm(in_ch)
            self.shortcut_conv = Conv2d(in_ch, planes, 1, stride, 0, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.conv1(F.relu(self.bn1(x, None, train)))
        out = self.conv2(F.relu(self.bn2(out, None, train)))
        if self.shortcut:
            x = self.shortcut_conv(F.relu(self.shortcut_bn(x, None, train)))
        return out + x


class RelativePositionBias(nn.Module):
    """The (2s − 1)² × heads table; ``forward(hq, wq)`` is the bias
    (heads, hq·wq, s²), each reduced position's row repeated over the
    (hq/s) × (wq/s) query cell it covers."""

    def __init__(self, num_heads: int, size: int):
        super().__init__()
        self.size = size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * size - 1) ** 2, num_heads))

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        self.relative_position_bias_table.copy_(
            0.02 * torch.randn(self.relative_position_bias_table.shape, generator=generator))

    def forward(self, hq: int, wq: int) -> torch.Tensor:
        s = self.size
        bias = relative_bias(self.relative_position_bias_table, s).reshape(s, 1, s, 1, s * s, -1)
        bias = bias.expand(s, hq // s, s, wq // s, s * s, bias.shape[-1])
        return bias.reshape(hq * wq, s * s, -1).permute(2, 0, 1)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, H, W, d·heads) with the channels dim_head-major → (B, heads, H·W, d)."""
    b, h, w, c = t.shape
    return t.reshape(b, h * w, c // heads, heads).permute(0, 3, 1, 2)


class _ReducedAttention(nn.Module):
    """softmax((q·kᵀ + bias)/√d) with k and v resized to reduce_size²,
    dropout on the probabilities, then ``to_out`` and its dropout."""

    def _attend(self, q, k, v, hq: int, wq: int, heads: int, train: bool, gen
                ) -> torch.Tensor:
        rs = self.reduce_size
        if k.shape[1] != rs:
            k = resize_bilinear_align_corners(k, (rs, rs))
            v = resize_bilinear_align_corners(v, (rs, rs))
        b, dt = q.shape[0], q.dtype
        q, k, v = _heads(q, heads), _heads(k, heads), _heads(v, heads)
        attn = scores(q, k)
        if self.rel_pos is not None:
            attn = attn + self.rel_pos(hq, wq)
        attn = torch.softmax(attn * (q.shape[-1] ** -0.5), dim=-1)
        attn = fast_dropout(attn, self.attn_drop, train, gen)
        out = attend(attn, v, dt).permute(0, 2, 3, 1).reshape(b, hq, wq, -1)
        return fast_dropout(self.to_out(out), self.proj_drop, train, gen)

    def _common(self, out_dim: int, heads: int, reduce_size: int, attn_drop: float,
                proj_drop: float, rel_pos: bool, dtype: torch.dtype) -> None:
        inner = (out_dim // heads) * heads
        self.reduce_size, self.attn_drop, self.proj_drop = reduce_size, attn_drop, proj_drop
        self.rel_pos = RelativePositionBias(heads, reduce_size) if rel_pos else None
        self.to_out = DWSepConv(inner, out_dim, dtype=dtype)


class LinearAttention(_ReducedAttention):
    """Self attention with K/V reduced to reduce_size² (``utnet.py:LinearAttention``)."""

    def __init__(self, dim: int, heads: int = 4, reduce_size: int = 8,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.to_qkv = DWSepConv(dim, 3 * (dim // heads) * heads, dtype=dtype)
        self._common(dim, heads, reduce_size, attn_drop, proj_drop, rel_pos, dtype)

    def forward(self, x: torch.Tensor, train: bool = False, gen=None) -> torch.Tensor:
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self._attend(q, k, v, x.shape[1], x.shape[2], self.heads, train, gen)


class LinearAttentionDecoder(_ReducedAttention):
    """Cross attention: q from the high-resolution input, k and v from the
    low-resolution one, reduced (``utnet.py:LinearAttentionDecoder``)."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 4, reduce_size: int = 8,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        inner = (out_dim // heads) * heads
        self.to_kv = DWSepConv(in_dim, 2 * inner, dtype=dtype)
        self.to_q = DWSepConv(out_dim, inner, dtype=dtype)
        self._common(out_dim, heads, reduce_size, attn_drop, proj_drop, rel_pos, dtype)

    def forward(self, q_feat: torch.Tensor, kv_feat: torch.Tensor, train: bool = False,
                gen=None) -> torch.Tensor:
        k, v = self.to_kv(kv_feat).chunk(2, dim=-1)
        q = self.to_q(q_feat)
        return self._attend(q, k, v, q_feat.shape[1], q_feat.shape[2], self.heads, train, gen)


class BasicTransBlock(nn.Module):
    """BN → attention → + x → BN → ReLU → 1×1 conv → +."""

    def __init__(self, in_ch: int, heads: int, reduce_size: int = 8,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = DomainBatchNorm(in_ch)
        self.attn = LinearAttention(in_ch, heads, reduce_size, attn_drop, proj_drop,
                                    rel_pos, dtype)
        self.bn2 = DomainBatchNorm(in_ch)
        self.mlp = Conv2d(in_ch, in_ch, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False, gen=None) -> torch.Tensor:
        out = self.attn(self.bn1(x, None, train), train, gen) + x
        return self.mlp(F.relu(self.bn2(out, None, train))) + out


class BasicTransDecoderBlock(nn.Module):
    """The cross-attention decoder block: a 1×1 conv of the low-resolution
    input, resized, as the residual; BN of both inputs → cross attention →
    + residual → BN → ReLU → 1×1 conv → +."""

    def __init__(self, in_ch: int, out_ch: int, heads: int, reduce_size: int = 8,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_ch = Conv2d(in_ch, out_ch, 1, dtype=dtype)
        self.bn_l = DomainBatchNorm(in_ch)
        self.bn_h = DomainBatchNorm(out_ch)
        self.attn = LinearAttentionDecoder(in_ch, out_ch, heads, reduce_size, attn_drop,
                                           proj_drop, rel_pos, dtype)
        self.bn2 = DomainBatchNorm(out_ch)
        self.mlp = Conv2d(out_ch, out_ch, 1, bias=False, dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, train: bool = False,
                gen=None) -> torch.Tensor:
        """x1 low resolution, x2 high resolution."""
        residue = resize_bilinear_align_corners(self.conv_ch(x1), (x2.shape[1], x2.shape[2]))
        out = self.attn(self.bn_h(x2, None, train), self.bn_l(x1, None, train), train, gen)
        out = out + residue
        return self.mlp(F.relu(self.bn2(out, None, train))) + out


class UTNet(nn.Module):
    """UTNet with the trainer's block_list '1234' wiring (``utnet.py:UTNet``)."""

    def __init__(self, base_chan: int = 32, num_classes: int = 1, reduce_size: int = 8,
                 num_blocks: Sequence[int] = (1, 1, 1, 1),
                 num_heads: Sequence[int] = (4, 4, 4, 4), attn_drop: float = 0.1,
                 proj_drop: float = 0.1, rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bc = base_chan
        self.num_blocks = tuple(num_blocks)
        kw = dict(reduce_size=reduce_size, attn_drop=attn_drop, proj_drop=proj_drop,
                  rel_pos=rel_pos, dtype=dtype)
        self.inc0 = BasicBlock(3, bc, dtype=dtype)
        self.inc1 = BasicBlock(bc, bc, dtype=dtype)
        for n, (cin, cout) in enumerate(((bc, 2 * bc), (2 * bc, 4 * bc), (4 * bc, 8 * bc),
                                         (8 * bc, 16 * bc)), start=1):
            self.add_module(f"down{n}_conv", BasicBlock(cin, cout, dtype=dtype))
            for i in range(num_blocks[n - 1]):
                self.add_module(f"down{n}_t{i}",
                                BasicTransBlock(cout, num_heads[n - 1], **kw))
        for n, (cin, cout, heads) in enumerate(((16 * bc, 8 * bc, num_heads[3]),
                                                (8 * bc, 4 * bc, num_heads[2]),
                                                (4 * bc, 2 * bc, num_heads[1])), start=1):
            self.add_module(f"up{n}_attn", BasicTransDecoderBlock(cin, cout, heads, **kw))
            self.add_module(f"up{n}_conv", BasicBlock(2 * cout, cout, dtype=dtype))
        self.up4_conv_ch = Conv2d(2 * bc, bc, 1, dtype=dtype)
        self.up4_conv = BasicBlock(2 * bc, bc, dtype=dtype)
        self.outc = Conv2d(bc, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, out_feat: bool = True, out_seg: bool = True,
                aux_mode: str = "none", gen: torch.Generator | None = None
                ) -> dict[str, Any]:
        """``{"seg": logits (B, H, W, 1), "feat": (B, 16·base_chan)}``, ``feat``
        the spatial mean of the deepest stage."""
        require_no_aux(aux_mode)
        x1 = self.inc1(self.inc0(x, train), train)
        feats = [x1]
        for n in range(1, 5):
            out = getattr(self, f"down{n}_conv")(_maxpool2(feats[-1]), train)
            for i in range(self.num_blocks[n - 1]):
                out = getattr(self, f"down{n}_t{i}")(out, train, gen)
            feats.append(out)
        x1, x2, x3, x4, x5 = feats
        feat = x5.mean(dim=(1, 2)) if out_feat else None
        if not out_seg:
            return {"seg": None, "feat": feat}
        out = x5
        for n, x_hi in enumerate((x4, x3, x2), start=1):
            out = getattr(self, f"up{n}_attn")(out, x_hi, train, gen)
            out = getattr(self, f"up{n}_conv")(torch.cat([out, x_hi], dim=-1), train)
        up = resize_bilinear_align_corners(out, (out.shape[1] * 2, out.shape[2] * 2))
        out = torch.cat([x1, self.up4_conv_ch(up)], dim=-1)
        return {"seg": self.outc(self.up4_conv(out, train)), "feat": feat}
