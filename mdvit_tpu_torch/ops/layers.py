"""Conv and MLP building blocks (``mdvit_tpu/ops/layers.py``), NHWC.

Parameters are fp32; each layer casts them and its input to its compute
``dtype`` (fp32 or bf16), as the flax modules' ``dtype`` does.

Dropout, DropPath and Dropout2d are identity in eval mode. In train mode each
call is the span ``mdvit.dropout`` (``utils.spans``), draws one uint32 seed
from an explicit CPU ``torch.Generator`` (``gen``) and hashes its mask's
element counters on the input's device (SplitMix32, the JAX package's
``fast_uniform``): no mask crosses from host to device, and one seed gives
the same masks on the CPU and on a card. JAX's threefry stream itself cannot
be matched. Under data parallelism a rank hashes the global counters of its
rows (``parallel.mesh.current_shard().row0`` rows in), so its masks are its
rows of the unsharded batch's.

Under context parallelism (``parallel.mesh.current_context()``) an element
mask (``fast_dropout``) of a tensor whose axis 1 (or the caller's
``row_axis``) is row-sharded (tokens or grid rows) follows JAX: in
``"stage"`` mode the shard index is folded into the seed,
``seed ^ (index · 0x9E3779B9)``, over local counters (JAX's
``FastDropout(axis_name=...)``); in ``"e2e"`` mode the counters are the
unsharded tensor's, sample b, global row (the rank's first row, from the
row split, + r), so the masks are the unsharded step's rows (JAX's GSPMD
path). Per-sample masks (DropPath, Dropout2d) are the same on every shard.
``Conv2d`` with a window of more than one row exchanges ``padding`` halo
rows with its neighbours in ``"e2e"`` mode and pads only W.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mdvit_tpu_torch.ops.norm import NormSpec, make_bn
from mdvit_tpu_torch.parallel.mesh import current_context, current_shard, halo_rows
from mdvit_tpu_torch.utils.spans import span

# Minimax fit of (b, a) in 0.5·x·(1+tanh(b(x+ax³))) to the exact erf GELU
# x·Φ(x) over [0, 10] (the JAX package's bf16 GELU); max |err| 2.7e-4.
_GELU_FIT_B = 0.8001570785492365
_GELU_FIT_A = 0.043367601640219106


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-accurate tanh-form GELU with refit constants, in x's dtype."""
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_FIT_B * (x + _GELU_FIT_A * (x ** 3))))
    return x * cdf


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU, except ``fast_gelu`` for bf16 (the JAX ``auto`` mode)."""
    if x.dtype == torch.bfloat16:
        return fast_gelu(x)
    return F.gelu(x)


_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x · k) mod 2³² for int64 x in [0, 2³²): k split in 16-bit halves so
    no product leaves int64."""
    hi, lo = k >> 16, k & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix32 finalizer (``mdvit_tpu/data/augment.py:_hash_u32``) on
    uint32 values held in int64."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fast_uniform(seed: int | torch.Tensor, shape, device: torch.device | str = "cpu",
                 offset: int = 0, first: int = 0,
                 counters: torch.Tensor | None = None) -> torch.Tensor:
    """U[0, 1) fp32 of ``shape`` from hashed row-major element counters,
    bit-equal to ``mdvit_tpu/data/augment.py:fast_uniform``. ``seed`` is a
    host int (dropout) or a 0-d int64 tensor on ``device`` (the augmentation
    noise, drawn on the device); ``offset`` picks an independent stream;
    ``first`` is the first element's counter (a rank's slice of a larger
    array); ``counters`` (int64, of ``shape``) replaces the row-major ones."""
    if counters is not None:
        idx = counters
    else:
        n = math.prod(int(s) for s in shape)
        idx = torch.arange(first, first + n, dtype=torch.int64,
                           device=device).reshape(tuple(shape))
    mix = (offset * 0x85EBCA6B) & _U32
    if isinstance(seed, torch.Tensor):
        base = _mul_u32(seed.to(torch.int64) & _U32, 0x9E3779B9)
    else:
        base = ((int(seed) & _U32) * 0x9E3779B9) & _U32
    bits = hash_u32(idx + base + mix)
    return (bits >> 8).float() * (1.0 / (1 << 24))


def fast_normal(seed: int | torch.Tensor, shape, device: torch.device | str = "cpu",
                offset: int = 0, first: int = 0) -> torch.Tensor:
    """N(0, 1) by Box–Muller on two hashed-uniform streams
    (``mdvit_tpu/data/augment.py:fast_normal``); ``log`` and ``cos`` round as
    the device's libm does, so it matches the JAX package to fp32 rounding."""
    u1 = fast_uniform(seed, shape, device, offset=offset * 2 + 1, first=first)
    u2 = fast_uniform(seed, shape, device, offset=offset * 2 + 2, first=first)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos((2.0 * math.pi) * u2)


def draw_seed(gen: torch.Generator | None) -> int:
    """One uint32 from ``gen`` (the JAX package's ``jax.random.bits``)."""
    if gen is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    return int(torch.randint(0, 1 << 32, (), dtype=torch.int64, generator=gen))


def _row_block_counters(shape, row0: int, ctx, device, axis: int = 1) -> torch.Tensor:
    """Counters of a (B, ..., A, ...) block whose axis ``axis`` is this rank's
    rows (a (B, H, W, C) grid's: two axes follow it) or row-major tokens (any
    other layout) of an unsharded (total batch, ..., Σ ranks' A, ...) tensor:
    sample row0 + b, that axis's index (the rank's first global row or
    token) + a, the other axes as they are."""
    shape = tuple(int(s) for s in shape)
    b, a = shape[0], shape[axis]
    pre, post = math.prod(shape[1:axis]), math.prod(shape[axis + 1:])
    split = ctx.split(a, tokens=len(shape) - axis != 3)
    start = sum(split[:ctx.index])
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    outer = (row0 + ar(b))[:, None] * pre + ar(pre)[None, :]  # (b, pre)
    idx = (outer * (sum(split) * post))[:, :, None, None] \
        + ((start + ar(a)) * post)[None, None, :, None] + ar(post)[None, None, None, :]
    return idx.reshape(shape)


def _keep_mask(keep: float, shape, gen, like: torch.Tensor,
               rows: int | None = None) -> torch.Tensor:
    """Bernoulli(keep) bools of ``shape`` (rows first), drawn on ``like``'s
    device at the counters of the current shard's rows; ``rows``: the axis
    that is row-sharded under context parallelism (module docstring), None
    where none is."""
    seed = draw_seed(gen)
    row0 = current_shard().row0
    ctx = current_context() if rows is not None else None
    if ctx is not None and ctx.mode == "e2e":
        counters = _row_block_counters(shape, row0, ctx, like.device, rows)
        return fast_uniform(seed, shape, device=like.device, counters=counters) < keep
    if ctx is not None:
        seed ^= (ctx.index * 0x9E3779B9) & _U32
    first = row0 * math.prod(shape[1:])
    return fast_uniform(seed, shape, device=like.device, first=first) < keep


def _dropped(x: torch.Tensor, rate: float, shape, gen, rows: int | None = None
             ) -> torch.Tensor:
    """``x`` with a Bernoulli(1 − rate) mask of ``shape`` (broadcast to x)
    applied and the kept values scaled by 1 / (1 − rate)."""
    keep = 1.0 - rate
    with span("mdvit.dropout"):
        mask = _keep_mask(keep, shape, gen, x, rows)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, train: bool, gen) -> torch.Tensor:
    """Stochastic depth (``layers.py:DropPath``): one keep draw per sample."""
    if rate == 0.0 or not train:
        return x
    return _dropped(x, rate, (x.shape[0],) + (1,) * (x.dim() - 1), gen)


def dropout2d(x: torch.Tensor, rate: float, train: bool, gen) -> torch.Tensor:
    """Channel dropout over NHWC (``layers.py:Dropout2d``): whole channels
    per sample."""
    if rate == 0.0 or not train:
        return x
    return _dropped(x, rate, (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],), gen)


def fast_dropout(x: torch.Tensor, rate: float, train: bool, gen, row_axis: int = 1
                 ) -> torch.Tensor:
    """Element dropout with hashed counters (``layers.py:FastDropout``); the
    row-sharded axis of a tensor of rank ≥ 3 under context parallelism is
    ``row_axis`` (UTNet's attention probabilities (B, heads, tokens, ·): 2):
    a grid's rows where two axes (W, C) follow it, else row-major tokens."""
    if rate == 0.0 or not train:
        return x
    return _dropped(x, rate, x.shape, gen, rows=row_axis if x.dim() >= 3 else None)


_CONSTANTS: dict = {}


def device_constant(key, make, device: torch.device, dtype: torch.dtype | None = None
                    ) -> torch.Tensor:
    """``torch.from_numpy(make())`` on ``device`` (as ``dtype``), kept for
    later calls under ``key``: the numpy constants a module bakes in (window
    masks, relative-position indices), made once a device, as JAX bakes them
    in at trace time. One made while a tracer runs (``torch.export``'s fake
    tensors) is not kept."""
    full = (key, device, dtype)
    t = _CONSTANTS.get(full)
    if t is None:
        t = torch.from_numpy(make()).to(device=device, dtype=dtype)
        if type(t) is torch.Tensor:
            _CONSTANTS[full] = t
    return t


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors, computing in ``compute_dtype``.

    ``x.permute(0, 3, 1, 2)`` of an NHWC tensor is a channels_last NCHW view,
    so the conv reads it without a copy and its output permutes back to NHWC.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         dilation=dilation, groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        x, padding = x.to(dt), self.padding
        ctx = current_context()
        if ctx is not None and ctx.mode == "e2e" and self.kernel_size[0] > 1:
            # row-sharded: the neighbours' rows replace the row padding (stride
            # s reads global rows s·o − p ..: s divides the rank's first row
            # and, on every rank but the last, its rows; the last rank's
            # ⌈h/s⌉ (SAME) or ⌊h/s⌋ (tiled) output rows end the grid's);
            # non-overlapping windows (kernel = stride, no padding) need none
            k, s, p = self.kernel_size[0], self.stride[0], padding[0]
            same = self.dilation[0] * (k - 1) == 2 * p
            tiled = p == 0 and k == s
            last = ctx.index == ctx.size - 1
            if (not (same or tiled) or (x.shape[1] % s and not last)
                    or ctx.start(x.shape[1]) % s):
                raise NotImplementedError(
                    "a row-sharded conv needs SAME row padding or non-overlapping windows, "
                    "a rank's first row divisible by the stride, and so its rows but on "
                    "the last rank")
            x = halo_rows(x, p, ctx)
            padding = (0, padding[1])
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), bias,
                     self.stride, padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class _NormOwner(nn.Module):
    """Holds a conv-path BatchNorm under the reference's name: ``bn``
    (shared) or ``bns`` (DSN, one per domain)."""

    def _set_bn(self, features: int, norm: NormSpec) -> None:
        self.dsn = norm.dsn
        if norm.dsn:
            self.bns = make_bn(features, norm)
        else:
            self.bn = make_bn(features, norm)

    def norm(self, x: torch.Tensor, domain_onehot: torch.Tensor | None,
             train: bool) -> torch.Tensor:
        return (self.bns if self.dsn else self.bn)(x, domain_onehot, train)


class ConvBN(_NormOwner):
    """Conv (no bias) → BN → act (reference ``Conv2d_BN``, DSN ``Conv2d_BN_M``;
    MDViT's stems take hardswish, a decoder's ``res_conv`` no act)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, act: str | None = "hardswish",
                 norm: NormSpec = NormSpec(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride, padding,
                           bias=False, dtype=dtype)
        self._set_bn(out_ch, norm)
        self.act = act

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        y = self.norm(self.conv(x), domain_onehot, train)
        return F.hardswish(y) if self.act == "hardswish" else y


class DWConvBN(_NormOwner):
    """Depthwise-separable conv → BN → hardswish, in the reference's two wirings:

    * ``dw_groups_on="in"`` (patch embeds): dw conv in→in, groups=in, then
      pointwise in→out;
    * ``dw_groups_on="out"`` (decoder ``conv_after``): grouped conv in→out,
      groups=out (2 input channels per group when in = 2·out), then
      pointwise out→out. The JAX package's even/odd ``dwconv_kernel
      (k, k, 2, C)`` is this conv's weight (C, 2, k, k) transposed.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dw_groups_on: str = "in",
                 norm: NormSpec = NormSpec(), dtype: torch.dtype = torch.float32):
        super().__init__()
        pad = (kernel_size - 1) // 2
        if dw_groups_on == "in":
            self.dwconv = Conv2d(in_ch, in_ch, kernel_size, stride, pad,
                                 groups=in_ch, bias=False, dtype=dtype)
            self.pwconv = Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype)
        elif dw_groups_on == "out":
            self.dwconv = Conv2d(in_ch, out_ch, kernel_size, stride, pad,
                                 groups=out_ch, bias=False, dtype=dtype)
            self.pwconv = Conv2d(out_ch, out_ch, 1, bias=False, dtype=dtype)
        else:
            raise ValueError(f"dw_groups_on must be 'in' or 'out', got {dw_groups_on!r}")
        self._set_bn(out_ch, norm)

    def forward(self, x: torch.Tensor, domain_onehot: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        return F.hardswish(self.norm(self.pwconv(self.dwconv(x)), domain_onehot, train))


class Mlp(nn.Module):
    """Transformer FFN: fc1 → GELU → drop1 → fc2 → drop2 (``FastDropout``)."""

    def __init__(self, in_features: int, hidden_features: int, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = Linear(hidden_features, in_features, dtype=dtype)
        self.drop = drop

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: torch.Generator | None = None) -> torch.Tensor:
        x = fast_dropout(gelu(self.fc1(x)), self.drop, train, gen)
        return fast_dropout(self.fc2(x), self.drop, train, gen)
