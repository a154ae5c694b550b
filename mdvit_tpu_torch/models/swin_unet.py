"""Swin-Unet and the Swin classifier (``mdvit_tpu/models/swin_unet.py``).

Shifted-window transformer U-Net (encoder depths (2, 2, 6, 2), heads
(3, 6, 12, 24), embed 96, window 8 at 256² in the registry's ``SwinUnet``),
patch merging down, ``PatchExpand`` up, skip concat + linear reduction, a
final ×4 patch expand and a 1×1 conv head. ``SwinClassifier`` (``swin_tiny``)
is the same blocks with a token-mean pool and a linear head.

Window partitioning is reshapes, the cyclic shift ``torch.roll``, and the
shifted-window mask and relative-position index are numpy constants made
once a device (``layers.device_constant``). Attention is explicit matrix
products and a softmax in fp32, as JAX computes it (bf16 operands are
widened to fp32, which is exact, so the products accumulate in fp32 as
``preferred_element_type`` does); no ``F.scaled_dot_product_attention``,
whose fused backwards do not repeat their bits. The relative-position bias
is ``table[index]``; its backward accumulates with ``index_put_``.

Submodules keep the flax module names (``layer{i}_block{j}``,
``downsample{i}``, ``up{i}_block{j}``, ``concat_back_dim{i}``, ...), so
``convert.from_jax_variables`` maps the leaves by name. No model here
reaches the port's kernels.

Under an end-to-end row shard (``parallel.mesh.current_context()``, mode
``"e2e"``) SwinUnet's token grids hold this rank's rows: the reshapes take
the local rows, the window and shift stay those of the global grid (fixed
at construction), and a block computes every window of the shifted frame
that holds one of its rows, on those windows' rows taken cyclically from
the ranks that hold them (``cyclic_rows``: the roll by −shift sends the
first rows past the last), with the mask rows of those windows by their
global index; it keeps its own rows. Patch merging and expanding are local
(every rank starts on an even row), the feature mean is the whole grid's.
The classifier is refused (``context_parallel_gap``).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mdvit_tpu_torch.ops.layers import (Conv2d, Linear, Mlp, device_constant, drop_path,
                                        fast_dropout)
from mdvit_tpu_torch.ops.norm import DomainLayerNorm
from mdvit_tpu_torch.parallel.mesh import current_context, cyclic_rows, spatial_mean


def _rel_pos_index(window: int) -> np.ndarray:
    """Relative position index (w², w²) into the (2w − 1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Attention mask of the shifted windows: (nW, n, n) of 0 / −100."""
    img_mask = np.zeros((h, w))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(h // window, window, w // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, window², C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_bias(table: torch.Tensor, size: int) -> torch.Tensor:
    """``table[index]`` of a (2s − 1)² relative-position table: (s², s², heads)."""
    idx = device_constant(("rel_pos_index", size), lambda: _rel_pos_index(size).reshape(-1),
                          table.device, torch.int64)
    return table[idx].reshape(size * size, size * size, -1)


def scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q·kᵀ of (…, n, d) operands in fp32, as JAX's einsum with
    ``preferred_element_type=float32`` (bf16 operands widen exactly)."""
    return torch.matmul(q.float(), k.float().transpose(-2, -1))


def attend(probs: torch.Tensor, v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """probs·v, the probabilities rounded to v's dtype first, the product in
    fp32, the result in ``out_dtype``."""
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(out_dtype)


class WindowAttention(nn.Module):
    """W-MSA with the relative position bias (``swin_unet.py:WindowAttention``).
    No dropout on the probabilities (JAX's has none), so no mask has window
    rows on axis 0 under context parallelism."""

    def __init__(self, dim: int, window: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = Linear(dim, dim, dtype=dtype)

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        self.relative_position_bias_table.copy_(
            0.02 * torch.randn(self.relative_position_bias_table.shape, generator=generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        bw, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        bias = relative_bias(self.relative_position_bias_table, self.window)
        attn = scores(qkv[0] * (c // h) ** -0.5, qkv[1]) + bias.permute(2, 0, 1)
        if mask is not None:  # (nW, n, n) over each image's windows
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n) + mask[:, None]).reshape(bw, h, n, n)
        out = attend(torch.softmax(attn, dim=-1), qkv[2], x.dtype)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class SwinBlock(nn.Module):
    """LN → (S)W-MSA → + drop-path → LN → MLP → + (``swin_unet.py:SwinBlock``).
    A grid no larger than the window takes one unshifted window."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window: int, shift: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        hres, wres = input_resolution
        if min(hres, wres) <= window:
            window, shift = min(hres, wres), 0
        self.resolution, self.window, self.shift = (hres, wres), window, shift
        self.drop_path = drop_path
        self.norm1 = DomainLayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads, dtype=dtype)
        self.norm2 = DomainLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        (hres, wres), window, shift = self.resolution, self.window, self.shift
        b, n, c = x.shape
        shortcut = x
        ctx = current_context()
        if ctx is not None and ctx.mode == "e2e":
            x = self._rows_attention(self.norm1(x).reshape(b, n // wres, wres, c), ctx)
        else:
            x = self.norm1(x).reshape(b, hres, wres, c)
            mask = None
            if shift > 0:
                x = torch.roll(x, (-shift, -shift), dims=(1, 2))
                mask = device_constant(("shift_mask", hres, wres, window, shift),
                                       lambda: _shift_attn_mask(hres, wres, window, shift),
                                       x.device)
            x = window_reverse(self.attn(window_partition(x, window), mask), window, hres, wres)
            if shift > 0:
                x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x.reshape(b, n, c), self.drop_path, train, gen)
        cur = self.mlp(self.norm2(x), train, gen)
        return x + drop_path(cur, self.drop_path, train, gen)

    def _rows_attention(self, x: torch.Tensor, ctx) -> torch.Tensor:
        """The (shifted) window attention of this rank's (B, h, W, C) rows
        under an end-to-end row shard: every window of the shifted frame
        that holds one of its rows, computed on rows [lo, hi) of the global
        grid (``cyclic_rows``), its own rows kept."""
        (hres, wres), window, shift = self.resolution, self.window, self.shift
        sizes = ctx.split(x.shape[1])
        starts = [sum(sizes[:r]) for r in range(len(sizes))]
        # shifted-frame row i is global row i + shift: window k spans global
        # rows [k·window + shift, (k + 1)·window + shift)
        ranges = [(((s - shift) // window) * window + shift,
                   -(-(s + n - shift) // window) * window + shift)
                  for s, n in zip(starts, sizes)]
        lo, hi = ranges[ctx.index]
        x = cyclic_rows(x, ranges, ctx)
        mask = None
        if shift > 0:
            x = torch.roll(x, -shift, dims=2)
            # the mask of each window row [lo, hi) spans, by its global index
            rows = [((lo - shift) // window + k) % (hres // window)
                    for k in range((hi - lo) // window)]
            mask = device_constant(("shift_mask_rows", hres, wres, window, shift, lo, hi),
                                   lambda: _shift_attn_mask(hres, wres, window, shift).reshape(
                                       hres // window, -1, window ** 2, window ** 2)[rows],
                                   x.device).flatten(0, 1)
        x = window_reverse(self.attn(window_partition(x, window), mask), window, hi - lo, wres)
        if shift > 0:
            x = torch.roll(x, shift, dims=2)
        own = starts[ctx.index] - lo
        return x[:, own:own + sizes[ctx.index]]


class PatchMerging(nn.Module):
    """2×2 neighbour concat → LN(4C) → Linear 4C → 2C, no bias."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution = input_resolution
        self.norm = DomainLayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        w = self.resolution[1]
        h = n // w  # this rank's rows under a row shard
        ctx = current_context()
        if ctx is not None and ctx.mode == "e2e" and (h % 2 or ctx.start(h) % 2):
            raise ValueError(f"a row-sharded patch merging needs every rank's rows and first "
                             f"row even; this rank holds {h} from row {ctx.start(h)}")
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, (h // 2) * (w // 2), 4 * c)))


class PatchExpand(nn.Module):
    """Linear (no bias), pixel shuffle ×``scale``, LN: ``PatchExpand`` at
    ``scale`` 2 (C → 2C, C/2 a pixel), JAX's ``FinalPatchExpandX4`` at 4
    (C → 16C, C a pixel)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, scale: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution, self.scale = input_resolution, scale
        self.out_dim = dim // 2 if scale == 2 else dim
        self.expand = Linear(dim, scale * scale * self.out_dim, bias=False, dtype=dtype)
        self.norm = DomainLayerNorm(self.out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, s, c = self.resolution[1], self.scale, self.out_dim
        b, h = x.shape[0], x.shape[1] // w  # this rank's rows under a row shard
        x = self.expand(x).reshape(b, h, w, s, s, c).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(b, s * h * s * w, c))


def _stage_blocks(owner: nn.Module, prefix: str, dim: int, res: int, depth: int,
                  heads: int, window: int, mlp_ratio: float, drop: float,
                  dprs: Sequence[float], dtype: torch.dtype) -> None:
    for j in range(depth):
        owner.add_module(f"{prefix}_block{j}", SwinBlock(
            dim, (res, res), heads, window, 0 if j % 2 == 0 else window // 2, mlp_ratio,
            drop, float(dprs[j]), dtype))


class _SwinEncoder(nn.Module):
    """Patch embed (a 4×4 stride-4 conv) + LN, and the four stages of Swin
    blocks with patch merging between them, as SwinUnet's and the
    classifier's ``__call__`` build them."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int,
                 depths: Sequence[int], num_heads: Sequence[int], window: int,
                 mlp_ratio: float, drop_rate: float, drop_path_rate: float,
                 dtype: torch.dtype):
        super().__init__()
        self.res0 = img_size // patch_size
        self.dims = [embed_dim * 2 ** i for i in range(4)]
        self.depths, self.drop_rate = tuple(depths), drop_rate
        self.dpr = np.linspace(0, drop_path_rate, sum(depths))
        self.patch_embed = Conv2d(3, embed_dim, patch_size, patch_size, 0, dtype=dtype)
        for i in range(4):
            res = self.res0 // 2 ** i
            first = sum(depths[:i])
            _stage_blocks(self, f"layer{i}", self.dims[i], res, depths[i], num_heads[i],
                          window, mlp_ratio, drop_rate, self.dpr[first:first + depths[i]],
                          dtype)
            if i < 3:
                self.add_module(f"downsample{i}", PatchMerging((res, res), self.dims[i], dtype))
        self.norm = DomainLayerNorm(self.dims[3])

    def embed(self, x: torch.Tensor, train: bool, gen) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        return fast_dropout(self.patch_norm(x), self.drop_rate, train, gen)

    def stages(self, x: torch.Tensor, train: bool, gen, skips: list | None = None
               ) -> torch.Tensor:
        for i in range(4):
            if skips is not None:
                skips.append(x)
            for j in range(self.depths[i]):
                x = getattr(self, f"layer{i}_block{j}")(x, train, gen)
            if i < 3:
                x = getattr(self, f"downsample{i}")(x)
        return self.norm(x)


class SwinUnet(_SwinEncoder):
    """Swin-Unet (``swin_unet.py:SwinUnet``), NHWC in, NHWC logits out."""

    context_parallel_gap = None

    def __init__(self, img_size: int = 256, patch_size: int = 4, num_classes: int = 1,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 8,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__(img_size, patch_size, embed_dim, depths, num_heads, window,
                         mlp_ratio, drop_rate, drop_path_rate, dtype)
        self.img_size = img_size
        self.patch_norm = DomainLayerNorm(embed_dim)
        dims, res0 = self.dims, self.res0
        for i in range(4):
            li = 3 - i
            res = res0 // 2 ** li
            if i == 0:
                self.up0 = PatchExpand((res, res), dims[li], dtype=dtype)
                continue
            self.add_module(f"concat_back_dim{i}", Linear(2 * dims[li], dims[li], dtype=dtype))
            first = sum(depths[:li])
            _stage_blocks(self, f"up{i}", dims[li], res, depths[li], num_heads[li], window,
                          mlp_ratio, drop_rate, self.dpr[first:first + depths[li]], dtype)
            if i < 3:
                self.add_module(f"up{i}_expand", PatchExpand((res, res), dims[li], dtype=dtype))
        self.norm_up = DomainLayerNorm(embed_dim)
        self.final_expand = PatchExpand((res0, res0), embed_dim, 4, dtype)
        self.output = Conv2d(embed_dim, num_classes, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False, out_feat: bool = True, out_seg: bool = True,
                aux_mode: str = "none", gen: torch.Generator | None = None
                ) -> dict[str, Any]:
        """``{"seg": logits (B, H, W, 1), "feat": (B, 8·embed)}``, ``feat``
        the token mean of the last stage. No domain input, no debranch."""
        require_no_aux(aux_mode)
        skips: list = []
        x = self.stages(self.embed(x, train, gen), train, gen, skips)
        feat = spatial_mean(x[:, :, None]) if out_feat else None
        if not out_seg:
            return {"seg": None, "feat": feat}
        for i in range(4):
            li = 3 - i
            if i == 0:
                x = self.up0(x)
                continue
            x = getattr(self, f"concat_back_dim{i}")(torch.cat([x, skips[li]], dim=-1))
            for j in range(self.depths[li]):
                x = getattr(self, f"up{i}_block{j}")(x, train, gen)
            if i < 3:
                x = getattr(self, f"up{i}_expand")(x)
        x = self.final_expand(self.norm_up(x))
        x = x.reshape(x.shape[0], -1, self.img_size, x.shape[-1])
        return {"seg": self.output(x), "feat": feat}


class SwinClassifier(_SwinEncoder):
    """The Swin classification backbone (``swin_unet.py:SwinClassifier``):
    patch embed (+ LN), optional absolute position embedding, the four
    stages, LN, token-mean pool, linear head."""

    # JAX's model_apply_context_parallel passes the domain one-hot
    # positionally, which lands on SwinClassifier.__call__(x, train)'s train
    context_parallel_gap = ("swin_tiny (SwinClassifier): JAX's model_apply_context_parallel "
                            "passes the domain one-hot positionally, where SwinClassifier's "
                            "call takes train, so JAX's CP cannot call it")

    def __init__(self, img_size: int = 224, patch_size: int = 4, num_classes: int = 1000,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, ape: bool = False, patch_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(img_size, patch_size, embed_dim, depths, num_heads, window,
                         mlp_ratio, drop_rate, drop_path_rate, dtype)
        self.patch_norm = DomainLayerNorm(embed_dim) if patch_norm else nn.Identity()
        self.absolute_pos_embed = (nn.Parameter(torch.zeros(1, self.res0 ** 2, embed_dim))
                                   if ape else None)
        self.head = (Linear(self.dims[3], num_classes, dtype=dtype) if num_classes > 0
                     else None)

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        if self.absolute_pos_embed is not None:  # truncated at ±2σ
            pe = torch.randn(self.absolute_pos_embed.shape, generator=generator)
            self.absolute_pos_embed.copy_(0.02 * pe.clamp(-2.0, 2.0))

    def embed(self, x: torch.Tensor, train: bool, gen) -> torch.Tensor:
        x = self.patch_embed(x)
        x = self.patch_norm(x.reshape(x.shape[0], self.res0 * self.res0, -1))
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(x.dtype)
        return fast_dropout(x, self.drop_rate, train, gen)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """``{"logits": (B, num_classes), "feat": (B, 8·embed)}``."""
        feat = self.stages(self.embed(x, train, gen), train, gen).mean(dim=1)
        return {"logits": feat if self.head is None else self.head(feat), "feat": feat}


def require_no_aux(aux_mode: str) -> None:
    """The zoo has no debranch: the train and eval steps pass ``"none"``."""
    if aux_mode != "none":
        raise ValueError(f"a comparator model has no debranch: aux_mode {aux_mode!r}")
