"""The randomness of the training step, in plain PyTorch: the SplitMix32
counter hash behind dropout, stochastic depth and the augmentation noise,
and the on-card augmentation (GaussNoise → flips → ShiftScaleRotate →
RandomBrightnessContrast → ImageNet normalisation, albumentations 1.1
semantics, cv2 ``warpAffine`` sampling with BORDER_REFLECT_101).

The system under test draws every dropout seed as one uint32 from a CPU
``torch.Generator`` and every augmentation value from a generator on the
card, both seeded with the step's seed, and hashes element counters on the
card. This module draws the same values in the same order from generators
of its own, seeded alike, so that its masks and augmented images are the
ones the step used. Nothing here is imported from the system under test.
"""
from __future__ import annotations

import math

import torch

U32 = 0xFFFFFFFF
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x · k) mod 2³² of int64 x in [0, 2³²), k in 16-bit halves."""
    hi, lo = k >> 16, k & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & U32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix32's finalizer on uint32 values held in int64."""
    x = x & U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform(seed, shape, device, offset: int = 0, first: int = 0) -> torch.Tensor:
    """U[0, 1) of ``shape`` from the hash of row-major counters starting at
    ``first``; ``seed`` a host int or a 0-d int64 tensor."""
    n = math.prod(int(s) for s in shape)
    idx = torch.arange(first, first + n, dtype=torch.int64, device=device).reshape(tuple(shape))
    mix = (offset * 0x85EBCA6B) & U32
    if isinstance(seed, torch.Tensor):
        base = _mul_u32(seed.to(torch.int64) & U32, 0x9E3779B9)
    else:
        base = ((int(seed) & U32) * 0x9E3779B9) & U32
    return (hash_u32(idx + base + mix) >> 8).float() * (1.0 / (1 << 24))


def normal(seed, shape, device, first: int = 0) -> torch.Tensor:
    """N(0, 1) by Box–Muller on the hash's streams 1 and 2."""
    u1 = uniform(seed, shape, device, offset=1, first=first)
    u2 = uniform(seed, shape, device, offset=2, first=first)
    return torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12))) * torch.cos(
        (2.0 * math.pi) * u2)


class SeedTape:
    """The dropout seeds of one forward, drawn from ``gen`` in the order the
    step draws them (one uint32 a call site) and kept, so that a forward
    computed in blocks of rows sees the same seed at each site. The trunk's
    sites come in order (``next``); the per-domain debranches' come after
    them, one a domain in domain order (``at``)."""

    def __init__(self, gen: torch.Generator):
        self.gen, self.seeds, self.pos = gen, [], 0

    def at(self, i: int) -> int:
        while len(self.seeds) <= i:
            self.seeds.append(int(torch.randint(0, 1 << 32, (), dtype=torch.int64,
                                                generator=self.gen)))
        return self.seeds[i]

    def next(self) -> int:
        self.pos += 1
        return self.at(self.pos - 1)

    def rewind(self) -> None:
        self.pos = 0


def keep_mask(keep: float, shape, seed: int, device, row0: int) -> torch.Tensor:
    """Bernoulli(keep) of ``shape``, rows first, at the counters of rows
    ``row0``.. of the whole batch."""
    return uniform(seed, shape, device, first=row0 * math.prod(shape[1:])) < keep


def dropout(x: torch.Tensor, rate: float, seed: int, row0: int) -> torch.Tensor:
    keep = 1.0 - rate
    return torch.where(keep_mask(keep, x.shape, seed, x.device, row0), x / keep,
                       torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, seed: int, row0: int) -> torch.Tensor:
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.where(keep_mask(keep, shape, seed, x.device, row0), x / keep,
                       torch.zeros_like(x))


def dropout2d(x: torch.Tensor, rate: float, seed: int, row0: int) -> torch.Tensor:
    """Whole channels of NHWC ``x`` a sample."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return torch.where(keep_mask(keep, shape, seed, x.device, row0), x / keep,
                       torch.zeros_like(x))


def normalize(images: torch.Tensor) -> torch.Tensor:
    """0..255 NHWC → clip, /255, ImageNet mean and std."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (torch.clamp(images.float(), 0.0, 255.0) / 255.0 - mean) / std


def aug_params(gen: torch.Generator, b: int, device) -> dict:
    """Every per-sample draw of a batch of ``b``, in the step's order."""

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def coin(*shape):
        return rand(*shape) < 0.5

    def between(lo, hi, *shape):
        return lo + (hi - lo) * rand(*shape)

    p = {"noise_apply": coin(b), "noise_var": between(10.0, 50.0, b)}
    p["noise_seed"] = torch.randint(0, 1 << 32, (), generator=gen, device=device,
                                    dtype=torch.int64)
    p["flip_h"], p["flip_v"] = coin(b), coin(b)
    ssr = coin(b)
    p["angle"] = torch.where(ssr, between(-45.0, 45.0, b), 0.0)
    p["scale"] = torch.where(ssr, 1.0 + between(-0.1, 0.1, b), 1.0)
    p["shift"] = torch.where(ssr[:, None], between(-0.0625, 0.0625, b, 2), 0.0)
    p["bc_apply"] = coin(b)
    p["alpha"], p["beta"] = 1.0 + between(-0.2, 0.2, b), between(-0.2, 0.2, b)
    return p


def _reflect101(c: torch.Tensor, size: int) -> torch.Tensor:
    if size == 1:
        return torch.zeros_like(c)
    period = 2 * (size - 1)
    c = torch.remainder(c, period)
    return torch.where(c >= size, period - c, c)


def _warp(images: torch.Tensor, masks: torch.Tensor, angle, scale, shift):
    """ShiftScaleRotate: the inverse of cv2's rotation matrix about the
    centre plus the shift, bilinear images and nearest (half up) masks."""
    b, h, w, _ = images.shape
    dev = images.device
    theta = angle.float() * (math.pi / 180.0)
    cos, sin = torch.cos(theta.double()).float(), torch.sin(theta.double()).float()
    alpha, beta = scale * cos, scale * sin
    cx, cy = w / 2.0, h / 2.0
    t0 = (1.0 - alpha) * cx - beta * cy + shift[:, 0] * w
    t1 = beta * cx + (1.0 - alpha) * cy + shift[:, 1] * h
    det = alpha * alpha - beta * (-beta)
    a = ((alpha / det, -beta / det), (beta / det, alpha / det))
    t = (-(a[0][0] * t0 + a[0][1] * t1), -(a[1][0] * t0 + a[1][1] * t1))
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)

    def src(row: int) -> torch.Tensor:
        a0, a1, tt = (v.view(b, 1, 1) for v in (a[row][0], a[row][1], t[row]))
        # the fused multiply-add, exact in fp64, then one rounding
        return (a0.double() * xs + (a1 * ys).double()).float() + tt

    sx, sy = src(0), src(1)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    xa, xb = _reflect101(x0i, w), _reflect101(x0i + 1, w)
    ya, yb = _reflect101(y0i, h), _reflect101(y0i + 1, h)
    top = images[bi, ya, xa] * (1 - fx) + images[bi, ya, xb] * fx
    bot = images[bi, yb, xa] * (1 - fx) + images[bi, yb, xb] * fx
    nx = _reflect101(torch.floor(sx + 0.5).long(), w)
    ny = _reflect101(torch.floor(sy + 0.5).long(), h)
    return top * (1 - fy) + bot * fy, masks[bi, ny, nx]


def augment(images: torch.Tensor, masks: torch.Tensor, p: dict, row0: int):
    """(normalised images, labels (B, H, W, 1)) of fp32 0..255 ``images``
    and {0, 1} ``masks`` that are rows ``row0``.. of the batch ``p`` was
    drawn for."""
    b = images.shape[0]
    p = {k: v if k == "noise_seed" else v[row0:row0 + b] for k, v in p.items()}

    def each(v):
        return v.view(b, 1, 1, 1)

    first = row0 * math.prod(images.shape[1:])
    noise = normal(p["noise_seed"], images.shape, images.device, first) * torch.sqrt(
        each(p["noise_var"]))
    x = torch.floor(torch.clamp(images + torch.where(each(p["noise_apply"]), noise, 0.0),
                                0.0, 255.0))
    fh, fv = each(p["flip_h"]), each(p["flip_v"])
    x = torch.where(fv, torch.where(fh, x.flip(2), x).flip(1), torch.where(fh, x.flip(2), x))
    m = torch.where(fh[..., 0], masks.flip(2), masks)
    m = torch.where(fv[..., 0], m.flip(1), m)
    x, m = _warp(x, m, p["angle"], p["scale"], p["shift"])
    bc = torch.clamp(x * each(p["alpha"]) + each(p["beta"]) * 255.0, 0.0, 255.0)
    x = torch.where(each(p["bc_apply"]), bc, x)
    return normalize(x), (m > 0.5).float()[..., None]
