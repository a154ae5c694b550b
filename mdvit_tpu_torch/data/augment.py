"""On-device train augmentation, the port of
``mdvit_tpu/data/augment.py:augment_batch`` (albumentations 1.1 semantics):

GaussNoise (p=0.5, var ~ U(10, 50), then ``floor(clip(·))``: albumentations
casts back to uint8) → horizontal and vertical flips (p=0.5 each) →
ShiftScaleRotate (p=0.5; angle ~ U(±45°), scale ~ 1 + U(±0.1), shift ~
U(±0.0625)·size; cv2 ``warpAffine`` semantics: bilinear image, nearest mask,
BORDER_REFLECT_101) → RandomBrightnessContrast (p=0.5; img·(1+U(±0.2)) +
U(±0.2)·255, clip) → norm01 and ImageNet normalisation.

Two halves: ``sample_aug_params(gen, b, device)`` draws every per-sample value
on the device from the step's generator (no host sync), and
``augment_with_params`` is deterministic in its inputs. JAX's threefry stream
cannot be matched, so the tests drive the second half with the values JAX
draws. The noise hashes counters with the same code as dropout
(``ops/layers.py:fast_normal``).

The warp is the exact per-pixel sampler of the JAX package
(``_affine_sample``, ``_rotation_matrix``, ``_reflect101``) batched with
integer indexing, in the JAX package's fp32 operation order. The JAX
package's production warp (``_ssr_apply_block``, one gather per 2×2 block)
is a TPU gather trick that equals this sampler at every pixel. The rotation's
cosine and sine are taken in fp64 and rounded to fp32, so the CPU and the
card compute the same matrix; the JAX package's fp32 libm may round them an
ulp apart.
"""
from __future__ import annotations

import math

import torch

from mdvit_tpu_torch.data.preprocess import normalize
from mdvit_tpu_torch.ops.layers import fast_normal

AugParams = dict[str, torch.Tensor]


def sample_aug_params(gen: torch.Generator, b: int,
                      device: torch.device | str) -> AugParams:
    """Every per-sample draw of one batch of ``b``, on ``device`` (``gen``'s
    device): apply flags, noise variance and seed, flips, angle, scale,
    shift, alpha and beta. A sample whose ShiftScaleRotate is off gets the
    identity (angle 0, scale 1, shift 0), as in the JAX package."""

    def uniform(lo: float, hi: float, *shape: int) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    def coin(*shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=device) < 0.5

    noise_apply, noise_var = coin(b), uniform(10.0, 50.0, b)
    noise_seed = torch.randint(0, 1 << 32, (), generator=gen, device=device,
                               dtype=torch.int64)
    flip_h, flip_v = coin(b), coin(b)
    ssr = coin(b)
    angle = torch.where(ssr, uniform(-45.0, 45.0, b), 0.0)
    scale = torch.where(ssr, 1.0 + uniform(-0.1, 0.1, b), 1.0)
    shift = torch.where(ssr[:, None], uniform(-0.0625, 0.0625, b, 2), 0.0)
    bc_apply = coin(b)
    alpha, beta = 1.0 + uniform(-0.2, 0.2, b), uniform(-0.2, 0.2, b)
    return {"noise_apply": noise_apply, "noise_var": noise_var, "noise_seed": noise_seed,
            "flip_h": flip_h, "flip_v": flip_v, "angle": angle, "scale": scale,
            "shift": shift, "bc_apply": bc_apply, "alpha": alpha, "beta": beta}


def reflect101(coord: torch.Tensor, size: int) -> torch.Tensor:
    """cv2 BORDER_REFLECT_101 index folding: …2 1 | 0 1 2 … n-1 | n-2 n-3"""
    if size == 1:
        return torch.zeros_like(coord)
    period = 2 * (size - 1)
    c = torch.remainder(coord, period)
    return torch.where(c >= size, period - c, c)


def rotation_matrix(angle: torch.Tensor, scale: torch.Tensor, dx: torch.Tensor,
                    dy: torch.Tensor, h: int, w: int):
    """Per-sample inverse map (A⁻¹ (B, 2, 2), t⁻¹ (B, 2)) of
    cv2.getRotationMatrix2D about (w/2, h/2) plus the albumentations shift
    (``_rotation_matrix``), fp32: dst(x) = src(A⁻¹x + t⁻¹)."""
    theta = angle.float() * (math.pi / 180.0)
    cos = torch.cos(theta.double()).float()
    sin = torch.sin(theta.double()).float()
    alpha, beta = scale * cos, scale * sin
    cx, cy = w / 2.0, h / 2.0
    t0 = (1.0 - alpha) * cx - beta * cy + dx * w
    t1 = beta * cx + (1.0 - alpha) * cy + dy * h
    det = alpha * alpha - beta * (-beta)
    a00, a01, a10, a11 = alpha / det, -beta / det, beta / det, alpha / det
    t_inv = torch.stack([-(a00 * t0 + a01 * t1), -(a10 * t0 + a11 * t1)], dim=-1)
    a_inv = torch.stack([torch.stack([a00, a01], -1), torch.stack([a10, a11], -1)], -2)
    return a_inv, t_inv


def warp(images: torch.Tensor, masks: torch.Tensor, angle: torch.Tensor,
         scale: torch.Tensor, shift: torch.Tensor):
    """ShiftScaleRotate of (B, H, W, C) fp32 images and (B, H, W) masks;
    ``angle`` (B,) degrees, ``scale`` (B,), ``shift`` (B, 2) fractions of W
    and H."""
    h, w = images.shape[1], images.shape[2]
    a_inv, t_inv = rotation_matrix(angle, scale, shift[:, 0], shift[:, 1], h, w)
    return warp_affine(images, masks, a_inv, t_inv)


def warp_affine(images: torch.Tensor, masks: torch.Tensor, a_inv: torch.Tensor,
                t_inv: torch.Tensor):
    """Sample each output pixel (x, y) of (B, H, W, C) images (bilinear) and
    (B, H, W) masks (nearest, half-up rounding) at A⁻¹(x, y) + t⁻¹, with
    reflect-101 borders (``_affine_sample`` batched): ``a_inv`` (B, 2, 2),
    ``t_inv`` (B, 2)."""
    b, h, w, _ = images.shape
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)

    def coeff(t: torch.Tensor) -> torch.Tensor:
        return t.view(b, 1, 1)

    def source(row: int) -> torch.Tensor:
        # fma(a0, x, a1·y) + t, the contraction XLA's CPU fusion makes of the
        # JAX package's a0·x + a1·y + t; the fma is exact in fp64 (a 24-bit
        # by 24-bit product), so the CPU and the card round it alike
        a0, a1, t = (coeff(v) for v in (a_inv[:, row, 0], a_inv[:, row, 1], t_inv[:, row]))
        return (a0.double() * xs + (a1 * ys).double()).float() + t

    sx, sy = source(0), source(1)
    bi = torch.arange(b, device=dev).view(b, 1, 1)

    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    xa, xb = reflect101(x0i, w), reflect101(x0i + 1, w)
    ya, yb = reflect101(y0i, h), reflect101(y0i + 1, h)
    top = images[bi, ya, xa] * (1 - fx) + images[bi, ya, xb] * fx
    bot = images[bi, yb, xa] * (1 - fx) + images[bi, yb, xb] * fx
    out_img = top * (1 - fy) + bot * fy

    nx = reflect101(torch.floor(sx + 0.5).long(), w)
    ny = reflect101(torch.floor(sy + 0.5).long(), h)
    return out_img, masks[bi, ny, nx]


def augment_raw(images: torch.Tensor, masks: torch.Tensor, params: AugParams):
    """The augmented (B, H, W, 3) images on the 0..255 scale and (B, H, W)
    masks, before normalisation; ``images`` fp32 0..255, ``masks`` {0, 1}."""
    b = images.shape[0]

    def per_sample(t: torch.Tensor) -> torch.Tensor:
        return t.view(b, 1, 1, 1)

    noise = fast_normal(params["noise_seed"], images.shape, images.device)
    noise = noise * torch.sqrt(per_sample(params["noise_var"]))
    x = torch.where(per_sample(params["noise_apply"]), noise, 0.0)
    x = torch.floor(torch.clamp(images + x, 0.0, 255.0))

    fh, fv = per_sample(params["flip_h"]), per_sample(params["flip_v"])
    x = torch.where(fh, x.flip(2), x)
    x = torch.where(fv, x.flip(1), x)
    m = torch.where(fh[..., 0], masks.flip(2), masks)
    m = torch.where(fv[..., 0], m.flip(1), m)

    x, m = warp(x, m, params["angle"], params["scale"], params["shift"])

    bc = torch.clamp(x * per_sample(params["alpha"]) + per_sample(params["beta"]) * 255.0,
                     0.0, 255.0)
    x = torch.where(per_sample(params["bc_apply"]), bc, x)
    return x, m


def augment_with_params(images: torch.Tensor, masks: torch.Tensor, params: AugParams):
    """(normalised images, labels (B, H, W, 1) ``mask > 0.5``)."""
    x, m = augment_raw(images, masks, params)
    return normalize(x), (m > 0.5).float()[..., None]


def augment_batch(gen: torch.Generator, images: torch.Tensor, masks: torch.Tensor):
    """Train-time augmentation with every draw from ``gen`` on the images'
    device: (normalised images, labels (B, H, W, 1))."""
    params = sample_aug_params(gen, images.shape[0], images.device)
    return augment_with_params(images, masks, params)
