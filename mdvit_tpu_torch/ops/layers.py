"""Conv and MLP building blocks (``mdvit_tpu/ops/layers.py``), NHWC.

Parameters are fp32; each layer casts them and its input to its compute
``dtype`` (fp32 or bf16), as the flax modules' ``dtype`` does.

Dropout, DropPath and Dropout2d are identity in eval mode. In train mode each
call is the span ``mdvit.dropout`` (``utils.spans``), draws one uint32 seed
from an explicit CPU ``torch.Generator`` (``gen``) and applies the custom op
``mdvit::dropout``, which hashes its mask's element counters (SplitMix32, the
JAX package's ``fast_uniform``) as it reads x: no mask crosses from host to
device, and one seed gives the same masks on the CPU and on a card. JAX's
threefry stream itself cannot be matched. On a card the op is one pass of
``csrc/dropout.cu`` (read x, write y); on the CPU it is ``dropout_ref``. Its
backward is the same op on the gradient: the mask is recomputed, not saved.
The op takes the counters as integers (``_counter_layout``): element e of x
has ``key + (e // row)·stride + e % row % period``, which covers element,
per-sample and per-channel masks and every shard below. Under data
parallelism a rank hashes the global counters of its rows
(``parallel.mesh.current_shard().row0`` rows in), so its masks are its rows
of the unsharded batch's.

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

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mdvit_tpu_torch.ops import kernels
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


def _splitmix32(x, mul):
    """SplitMix32's finalizer (``mdvit_tpu/data/augment.py:_hash_u32``) on a
    fresh tensor or array ``x`` of uint32 values, shifts and xors in place;
    ``mul(x, k)`` is (x · k) mod 2³² in x's arithmetic."""
    x ^= x >> 16
    x = mul(x, 0x7FEB352D)
    x ^= x >> 15
    x = mul(x, 0x846CA68B)
    x ^= x >> 16
    return x


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix32 finalizer on uint32 values held in int64."""
    return _splitmix32(x & _U32, _mul_u32)


def fast_uniform(seed: int | torch.Tensor, shape, device: torch.device | str = "cpu",
                 offset: int = 0, first: int = 0) -> torch.Tensor:
    """U[0, 1) fp32 of ``shape`` from hashed row-major element counters,
    bit-equal to ``mdvit_tpu/data/augment.py:fast_uniform``. ``seed`` is a
    host int or a 0-d int64 tensor on ``device`` (the augmentation noise,
    drawn on the device); ``offset`` picks an independent stream; ``first``
    is the first element's counter (a rank's slice of a larger array)."""
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


def _counter_layout(shape, mask_shape, gen, rows: int | None) -> tuple:
    """``mdvit::dropout``'s (key, row, stride, period) for x of ``shape`` and
    a mask of ``mask_shape`` (rows first; broadcast to ``shape`` over all but
    the sample, or all but the sample and channel), drawn at the counters of
    the current shard's rows; ``rows``: the axis that is row-sharded under
    context parallelism (module docstring), None where none is."""
    seed = draw_seed(gen)
    row0 = current_shard().row0
    ctx = current_context() if rows is not None else None
    if ctx is not None and ctx.mode == "e2e":
        # the unsharded (total batch, ..., Σ ranks' A, ...) tensor's counters:
        # sample row0 + b, the axis's global index (the rank's first) + a
        a = shape[rows]
        pre, post = math.prod(shape[1:rows]), math.prod(shape[rows + 1:])
        split = ctx.split(a, tokens=len(shape) - rows != 3)
        stride = sum(split) * post
        first = row0 * pre * stride + sum(split[:ctx.index]) * post
        return _seed_key(seed, first), a * post, stride, a * post
    if ctx is not None:
        seed ^= (ctx.index * 0x9E3779B9) & _U32
    period = math.prod(mask_shape[1:])
    return _seed_key(seed, row0 * period), math.prod(shape[1:]), period, period


def _seed_key(seed: int, first: int) -> int:
    """The hash's base for ``seed`` (``fast_uniform``'s) plus the first
    counter, mod 2³²."""
    return ((int(seed) & _U32) * 0x9E3779B9 + first) & _U32


def dropout_ref(x: Tensor, keep: float, key: int, row: int, stride: int,
                period: int) -> Tensor:
    """Plain version of ``mdvit::dropout``: x / keep where element e's
    counter ``key + (e // row)·stride + e % row % period`` (mod 2³²) hashes
    below keep (``fast_uniform``'s hash and compare), else 0. The mask is
    hashed at its own shape (rows, 1, period) and broadcast over x as
    (rows, row / period, period): on the CPU in numpy's uint32 arithmetic
    (a third of ``hash_u32``'s CPU time), elsewhere by ``hash_u32`` on x's
    device."""
    n = x.numel()
    if n == 0:
        return torch.empty_like(x)
    rows, stride = n // row, stride & _U32
    if x.device.type == "cpu":
        c = (np.uint32(key) + np.arange(rows, dtype=np.uint32)[:, None, None]
             * np.uint32(stride) + np.arange(period, dtype=np.uint32))
        h = _splitmix32(c, lambda a, k: np.multiply(a, np.uint32(k), out=a))
        bits = torch.from_numpy((h >> 8).astype(np.float32))
    else:
        ar = lambda k: torch.arange(k, device=x.device)  # noqa: E731
        bits = (hash_u32(key + ar(rows)[:, None, None] * stride + ar(period)) >> 8).float()
    mask = bits * (1.0 / (1 << 24)) < keep
    x3 = x.reshape(rows, row // period, period)
    return torch.where(mask, x3 / keep, torch.zeros_like(x3)).reshape(x.shape)


# a launch's elements: the kernel indexes in 32 bits
_LAUNCH_ELEMENTS = 2 ** 31 - 1


def _dropout_cuda(x: Tensor, keep: float, key: int, row: int, stride: int,
                  period: int) -> Tensor:
    """``dropout_ref`` by ``csrc/dropout.cu``: one launch (a launch per
    ``_LAUNCH_ELEMENTS // row`` rows beyond 2³¹ elements)."""
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("dropout: want a contiguous CUDA tensor")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    if not 0 < period <= row <= _LAUNCH_ELEMENTS or row % period or n % row:
        raise ValueError(f"dropout: rows of {row} elements in periods of {period} "
                         f"do not tile {tuple(x.shape)}")
    lib = kernels.library("dropout")
    code = 2 if x.dtype == torch.float64 else kernels.dtype_code(x.dtype)
    item = x.element_size()
    rows = _LAUNCH_ELEMENTS // row
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0 in range(0, n // row, rows):
            xp, yp = x.data_ptr() + r0 * row * item, y.data_ptr() + r0 * row * item
            status = lib.mdvit_dropout(
                code, xp, yp, min(rows, n // row - r0) * row, (key + r0 * stride) & _U32,
                row, stride & _U32, period, keep, int(xp % 16 == 0 and yp % 16 == 0), stream)
            kernels.check_status("dropout", status)
    kernels.LAUNCHES["dropout"] += 1
    return y


@torch.library.custom_op("mdvit::dropout", mutates_args=(), device_types="cuda")
def _dropout_op(x: Tensor, keep: float, key: int, row: int, stride: int,
                period: int) -> Tensor:
    return _dropout_cuda(x, keep, key, row, stride, period)


_dropout_op.register_kernel("cpu", dropout_ref)


@_dropout_op.register_fake
def _dropout_fake(x, keep, key, row, stride, period):
    return torch.empty_like(x)


def _dropout_setup(ctx, inputs, output):
    ctx.layout = inputs[1:]


def _dropout_grad(ctx, g):
    # where's backward, then the divide's: the same mask and scale on g
    return (torch.ops.mdvit.dropout(g.contiguous(), *ctx.layout),) + (None,) * 5


_dropout_op.register_autograd(_dropout_grad, setup_context=_dropout_setup)


def _dropped(x: torch.Tensor, rate: float, shape, gen, rows: int | None = None
             ) -> torch.Tensor:
    """``x`` with a Bernoulli(1 − rate) mask of ``shape`` (broadcast to x)
    applied and the kept values scaled by 1 / (1 − rate)."""
    with span("mdvit.dropout"):
        layout = _counter_layout(x.shape, shape, gen, rows)
        return torch.ops.mdvit.dropout(x.contiguous(), 1.0 - rate, *layout)


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
