"""SwinUNETR (``mdvit_tpu/models/swin_unetr.py``), 2-D: a Swin encoder
(patch 2, dims 48·2^i, depths (2, 2, 2, 2), heads (3, 6, 12, 24), window 8)
feeding UNETR residual conv blocks (InstanceNorm + LeakyReLU) with
transposed-conv upsampling.

``UnetrUpBlock``'s ``transp_conv`` is flax's ``nn.ConvTranspose`` (kernel 2,
stride 2, ``SAME``, ``transpose_kernel=False``), which does not turn its
kernel: out[2i + t] = x[i]·w[1 − t] on each axis, where
``torch.nn.ConvTranspose2d`` gives x[i]·W[t]. So the port's (in, out, kh, kw)
weight is the flax (kh, kw, in, out) kernel with both spatial axes flipped
(``convert.py``; ``tests/test_torch_zoo_swin.py`` holds the mapping alone).

Under an end-to-end row shard the Swin blocks run as SwinUnet's do, the
reshapes take this rank's rows, the 3×3 convs exchange halo rows, the
transposed convs (kernel = stride) are local, and InstanceNorm's moments
and the feature mean are the whole grid's (``spatial_moments``,
``spatial_mean``).
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.models.swin_unet import PatchMerging, SwinBlock, require_no_aux
from mdvit_tpu_torch.ops.layers import Conv2d
from mdvit_tpu_torch.parallel.mesh import spatial_mean, spatial_moments


class InstanceNorm(nn.Module):
    """Per-sample, per-channel moments over H and W in fp32 (the whole grid's
    under a row shard), eps 1e-5, with an affine (``scale``/``bias`` in
    flax, ``weight``/``bias`` here)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean, var = spatial_moments(x)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """A kernel-2 stride-2 transposed conv without bias on NHWC tensors,
    computing in ``compute_dtype``; weight (in, out, 2, 2), lecun-normal
    init as flax's ``ConvTranspose``."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 2, stride=2, bias=False)
        self.compute_dtype = dtype

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        std = 1.0 / math.sqrt(self.in_channels * 4)
        self.weight.copy_(std * torch.randn(self.weight.shape, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), None, 2)
        return y.permute(0, 2, 3, 1)


class UnetrBasicBlock(nn.Module):
    """Residual block: (3×3 conv → IN → lrelu) → 3×3 conv → IN, plus a
    1×1 conv → IN skip when the width changes, then lrelu."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, 1, 1, bias=False, dtype=dtype)
        self.norm1 = InstanceNorm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, 1, 1, bias=False, dtype=dtype)
        self.norm2 = InstanceNorm(out_ch)
        self.skip = in_ch != out_ch
        if self.skip:
            self.conv3 = Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype)
            self.norm3 = InstanceNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        out = self.norm2(self.conv2(out))
        if self.skip:
            x = self.norm3(self.conv3(x))
        return F.leaky_relu(out + x, 0.01)


class UnetrUpBlock(nn.Module):
    """Transposed-conv ×2 upsample → concat skip → ``UnetrBasicBlock``."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transp_conv = ConvTranspose2x2(in_ch, out_ch, dtype)
        self.conv_block = UnetrBasicBlock(out_ch + skip_ch, out_ch, dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class SwinUNETR(nn.Module):
    """2-D SwinUNETR: Swin encoder (patch 2) + UNETR conv decoder."""

    context_parallel_gap = None

    def __init__(self, img_size: int = 256, in_channels: int = 3, out_channels: int = 1,
                 feature_size: int = 48, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 8,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        fs = feature_size
        self.res0, self.depths = img_size // 2, tuple(depths)
        dims = [fs * 2 ** i for i in range(4)]
        self.patch_embed = Conv2d(in_channels, fs, 2, 2, 0, dtype=dtype)
        for i in range(4):
            res = self.res0 // 2 ** i
            for j in range(depths[i]):  # the JAX module passes no drop path
                self.add_module(f"swin{i}_block{j}", SwinBlock(
                    dims[i], (res, res), num_heads[i], window,
                    0 if j % 2 == 0 else window // 2, dtype=dtype))
            self.add_module(f"merge{i}", PatchMerging((res, res), dims[i], dtype))
        self.encoder1 = UnetrBasicBlock(in_channels, fs, dtype)
        self.encoder2 = UnetrBasicBlock(fs, fs, dtype)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, dtype)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, dtype)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs, dtype)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, 8 * fs, dtype)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, 4 * fs, dtype)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, 2 * fs, dtype)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, fs, dtype)
        self.decoder1 = UnetrUpBlock(fs, fs, fs, dtype)
        self.out = Conv2d(fs, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, out_feat: bool = True, out_seg: bool = True,
                aux_mode: str = "none", gen: torch.Generator | None = None
                ) -> dict[str, Any]:
        """``{"seg": logits (B, H, W, 1), "feat": (B, 16·fs)}``, ``feat`` the
        spatial mean of the last merge's output."""
        require_no_aux(aux_mode)
        x_in = x
        h = self.patch_embed(x)
        b = h.shape[0]
        t = h.reshape(b, -1, h.shape[-1])
        hidden = []
        for i in range(4):
            res = self.res0 // 2 ** i
            hidden.append(t.reshape(b, -1, res, t.shape[-1]))  # this rank's rows
            for j in range(self.depths[i]):
                t = getattr(self, f"swin{i}_block{j}")(t, train, gen)
            t = getattr(self, f"merge{i}")(t)
        res4 = self.res0 // 16
        x4 = t.reshape(b, -1, res4, t.shape[-1])
        feat = spatial_mean(x4) if out_feat else None
        if not out_seg:
            return {"seg": None, "feat": feat}
        enc0 = self.encoder1(x_in)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec4 = self.encoder10(x4)
        dec3 = self.decoder5(dec4, hidden[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return {"seg": self.out(self.decoder1(dec0, enc0)), "feat": feat}
