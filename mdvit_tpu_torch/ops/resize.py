"""Bilinear resizes (``mdvit_tpu/ops/resize.py``), NHWC.

Separable, as the JAX package's ``align_corners=True`` resize is
(``_ac_resize_matrix``): one (out, in) interpolation matrix an axis, applied
as two matrix products. ``resize_bilinear`` takes half-pixel source
coordinates (``F.interpolate(align_corners=False)``'s, no antialiasing),
over W and then over H; ``resize_bilinear_align_corners`` takes
s = o·(in−1)/(out−1) (UTNet's and TransFuse's upsamples), over H and then
over W, as JAX does. The backward is two products too: ``F.interpolate``'s
CUDA backward accumulates with atomics, so its bits move from run to run,
and ``torch.use_deterministic_algorithms`` refuses it.

Under an end-to-end row shard (``parallel.mesh.current_context()``, mode
``"e2e"``) both resizes' H axis is this rank's block of rows of grids split
over the ctx ranks as ``RowShard.split`` says (unequal blocks allowed):
each rank takes, as a halo, the input rows its output rows reach, and
applies its rows of the global row matrix restricted to them;
``local_size`` turns a global target size into the rank's.
``resize_ac_whole`` resizes the whole grid to a size every rank holds
whole (UTNet's reduced keys and values): each rank multiplies its rows by
its columns of the row matrix and the products are summed over the ranks.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mdvit_tpu_torch.ops.layers import device_constant
from mdvit_tpu_torch.parallel.mesh import all_reduce_sum, current_context, halo_rows


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) fp32 weights of ``F.interpolate(mode="bilinear",
    align_corners=False)`` along one axis: source s = (o + ½)·in/out − ½,
    clamped at 0; taps ⌊s⌋ and ⌊s⌋ + 1 (clamped at in − 1)."""
    m = np.zeros((out_size, in_size), np.float32)
    scale = np.float32(in_size / out_size)
    for o in range(out_size):
        s = max(np.float32(scale * np.float32(o + 0.5) - np.float32(0.5)), np.float32(0.0))
        i0 = min(int(s), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        f = np.float32(s - np.float32(i0))
        m[o, i0] += np.float32(1.0) - f
        m[o, i1] += f
    return m


def ac_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) fp32 weights of ``F.interpolate(mode="bilinear",
    align_corners=True)`` along one axis (``resize.py:_ac_resize_matrix``):
    source s = o·(in−1)/(out−1); taps ⌊s⌋ and ⌊s⌋ + 1 (clamped at in − 1)."""
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    for o in range(out_size):
        s = o * scale
        s0 = int(np.floor(s))
        f = s - s0
        s0 = min(s0, in_size - 1)
        s1 = min(s0 + 1, in_size - 1)
        m[o, s0] += 1.0 - f
        m[o, s1] += f
    return m


def _matrix(in_size: int, out_size: int, device: torch.device,
            align_corners: bool = False) -> torch.Tensor:
    make = ac_resize_matrix if align_corners else resize_matrix
    return device_constant((make.__name__, in_size, out_size),
                           lambda: make(in_size, out_size), device)


def _row_block_matrix(rows_in: tuple, rows_out: tuple, index: int,
                      align_corners: bool = False):
    """(halo, M) of rank ``index`` resizing its block of a grid split
    ``rows_in`` over the ranks to its block of one split ``rows_out``: the
    halo every rank needs (the largest reach outside its own input block),
    and the rank's rows of the global matrix over its halo'd input rows
    (zero columns past the global edges)."""
    m = (ac_resize_matrix if align_corners else resize_matrix)(sum(rows_in), sum(rows_out))
    first_in, first_out = np.cumsum((0,) + rows_in), np.cumsum((0,) + rows_out)
    halo = 0
    for r in range(len(rows_in)):
        cols = np.nonzero(m[first_out[r]:first_out[r + 1]].any(axis=0))[0]
        halo = max(halo, int(first_in[r] - cols.min()), int(cols.max() - (first_in[r + 1] - 1)))
    padded = np.pad(m, ((0, 0), (halo, halo)))
    lo = int(first_in[index])
    return halo, np.ascontiguousarray(
        padded[first_out[index]:first_out[index + 1], lo:lo + rows_in[index] + 2 * halo])


def local_size(size: Sequence[int]) -> tuple[int, int]:
    """A global (H, W) target as this rank's (rows of H, W) under an
    end-to-end row shard; as it is otherwise."""
    ctx = current_context()
    h, w = int(size[0]), int(size[1])
    if ctx is None or ctx.mode != "e2e":
        return h, w
    return ctx.local_rows(h), w


def _resize_rows_sharded(y: torch.Tensor, h: int, ctx, align_corners: bool = False
                         ) -> torch.Tensor:
    """The H pass of either resize on this rank's rows (fp32 (B, H_in, W, C)
    → (B, h, W, C))."""
    b, hi, w, c = y.shape
    rows_in, rows_out = ctx.split(hi), ctx.split(h)
    halo, m = _row_block_matrix(rows_in, rows_out, ctx.index, align_corners)
    mat = device_constant(("resize_rows", rows_in, rows_out, ctx.index, align_corners),
                          lambda: m, y.device)
    y = halo_rows(y, halo, ctx)
    return (mat @ y.reshape(b, hi + 2 * halo, w * c)).reshape(b, h, w, c)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Resize NHWC ``(B, H, W, C)`` to ``(B, size[0], size[1], C)`` in fp32,
    no antialiasing; returns ``x`` itself when the size already matches."""
    h, w = int(size[0]), int(size[1])
    b, hi, wi, c = x.shape
    if hi == h and wi == w:
        return x
    y = x.float()
    if wi != w:  # (W_out, W_in) @ (B·H, W_in, C)
        y = (_matrix(wi, w, x.device) @ y.reshape(b * hi, wi, c)).reshape(b, hi, w, c)
    ctx = current_context()
    if hi != h and ctx is not None and ctx.mode == "e2e":
        y = _resize_rows_sharded(y, h, ctx)
    elif hi != h:  # (H_out, H_in) @ (B, H_in, W·C)
        y = (_matrix(hi, h, x.device) @ y.reshape(b, hi, w * c)).reshape(b, h, w, c)
    return y.to(x.dtype)


def resize_bilinear_align_corners(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``F.interpolate(mode="bilinear", align_corners=True)`` of NHWC ``x``
    to ``(B, size[0], size[1], C)`` in fp32, over H then W
    (``resize.py:resize_bilinear_align_corners``); returns ``x`` itself when
    the size already matches."""
    h, w = int(size[0]), int(size[1])
    b, hi, wi, c = x.shape
    if hi == h and wi == w:
        return x
    y = x.float()
    ctx = current_context()
    if hi != h and ctx is not None and ctx.mode == "e2e":
        y = _resize_rows_sharded(y, h, ctx, align_corners=True)
    elif hi != h:  # (H_out, H_in) @ (B, H_in, W·C)
        y = (_matrix(hi, h, x.device, True) @ y.reshape(b, hi, wi * c)).reshape(b, h, wi, c)
    if wi != w:  # (W_out, W_in) @ (B·H, W_in, C)
        y = (_matrix(wi, w, x.device, True) @ y.reshape(b * h, wi, c)).reshape(b, h, w, c)
    return y.to(x.dtype)


def resize_ac_whole(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``resize_bilinear_align_corners`` of the whole grid to ``size``, the
    whole result on every rank under an end-to-end row shard: each rank
    multiplies its rows by its columns of the (size[0], H) row matrix and
    one all-reduce of the (B, size[0], W, C) products sums them (the
    backward sums the ranks' gradients, each rank's use being its own),
    then the W pass. Unsharded: ``resize_bilinear_align_corners``."""
    ctx = current_context()
    if ctx is None or ctx.mode != "e2e":
        return resize_bilinear_align_corners(x, size)
    h, w = int(size[0]), int(size[1])
    b, hi, wi, c = x.shape
    rows = ctx.split(hi)
    total, start = sum(rows), sum(rows[:ctx.index])
    cols = device_constant(("ac_columns", total, h, start, hi),
                           lambda: ac_resize_matrix(total, h)[:, start:start + hi].copy(),
                           x.device)
    y = all_reduce_sum(cols @ x.float().reshape(b, hi, wi * c), ctx.group).reshape(b, h, wi, c)
    if wi != w:
        y = (_matrix(wi, w, x.device, True) @ y.reshape(b * h, wi, c)).reshape(b, h, w, c)
    return y.to(x.dtype)
