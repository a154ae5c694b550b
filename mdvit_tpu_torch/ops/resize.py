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
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mdvit_tpu_torch.ops.layers import device_constant


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
    if hi != h:  # (H_out, H_in) @ (B, H_in, W·C)
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
    if hi != h:  # (H_out, H_in) @ (B, H_in, W·C)
        y = (_matrix(hi, h, x.device, True) @ y.reshape(b, hi, wi * c)).reshape(b, h, wi, c)
    if wi != w:  # (W_out, W_in) @ (B·H, W_in, C)
        y = (_matrix(wi, w, x.device, True) @ y.reshape(b * h, wi, c)).reshape(b, h, w, c)
    return y.to(x.dtype)
