"""Bilinear resize with ``align_corners=False`` (``mdvit_tpu/ops/resize.py``).

Separable, as the JAX package's ``align_corners=True`` resize is
(``_ac_resize_matrix``): one (out, in) interpolation matrix an axis with
half-pixel source coordinates (``F.interpolate``'s, no antialiasing), applied
as two matrix products, over W and then over H. The backward is two products
too: ``F.interpolate``'s CUDA backward accumulates with atomics, so its bits
move from run to run, and ``torch.use_deterministic_algorithms`` refuses it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_MATRICES: dict[tuple[int, int, torch.device], torch.Tensor] = {}


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


def _matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The matrix on ``device``, kept for later calls; one made while a
    tracer runs (``torch.export``'s fake tensors) is not kept."""
    key = (in_size, out_size, device)
    m = _MATRICES.get(key)
    if m is None:
        m = torch.from_numpy(resize_matrix(in_size, out_size)).to(device)
        if type(m) is torch.Tensor:
            _MATRICES[key] = m
    return m


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
