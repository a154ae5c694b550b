"""Inputs from the seed, made on the device in a few large calls.

Images are lesion-like: an elliptical mask a sample (centre in the middle
half, radii a tenth to a quarter of the side), and an RGB image of uniform
noise made brighter inside the mask. Train indices are one permutation a
domain an epoch, B consecutive rows a step, as the trainer draws them;
they are drawn on the device, so feeding a step waits for nothing.
"""
from __future__ import annotations

import torch

# the tags that split one run's seed into independent streams
WEIGHTS, STORES, INDICES, STEP, POOL, CALIBRATION, SAMPLE = range(7)


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sub_seed(seed: int, tag: int) -> int:
    """An independent 63-bit seed for the stream ``tag`` of the run ``seed``."""
    return (seed * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def lesions(gen: torch.Generator, n: int, img: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(uint8 images (n, img, img, 3), uint8 masks (n, img, img))."""
    c = img * (0.25 + 0.5 * torch.rand((2, n, 1, 1), generator=gen, device=device))
    r = img * (0.1 + 0.15 * torch.rand((2, n, 1, 1), generator=gen, device=device))
    y = torch.arange(img, device=device, dtype=torch.float32).view(1, img, 1)
    inside = ((y - c[0]) / r[0]) ** 2 + ((y.view(1, 1, img) - c[1]) / r[1]) ** 2 < 1
    noise = torch.randint(0, 160, (n, img, img, 3), generator=gen, device=device,
                          dtype=torch.uint8)
    return noise + 90 * inside[..., None].to(torch.uint8), inside.to(torch.uint8)


def stores(seed: int, domains: int, n: int, img: int, device):
    """Per-domain uint8 stores: (images tuple, masks tuple)."""
    gen = generator(seed, STORES, device)
    pairs = [lesions(gen, n, img, device) for _ in range(domains)]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


class Epochs:
    """(D, B) int64 index rows on the device: a fresh permutation of each
    domain's ``n`` rows an epoch, ``n // b`` steps an epoch."""

    def __init__(self, seed: int, domains: int, n: int, b: int, device):
        self.gen = generator(seed, INDICES, device)
        self.shape, self.b, self.device = (domains, n), b, device
        self.steps = n // b
        self.k = 0
        self.perm = None

    def next(self) -> torch.Tensor:
        s = self.k % self.steps
        if s == 0:
            self.perm = torch.argsort(torch.rand(self.shape, generator=self.gen,
                                                 device=self.device), dim=1)
        self.k += 1
        return self.perm[:, s * self.b:(s + 1) * self.b]


def pool(seed: int, batches: int, b: int, img: int, domains: int, device, tag: int = POOL):
    """``batches`` serving batches: (fp32 0..255 images (b, img, img, 3),
    one-hots (b, D)), each with b / D images of every domain in a drawn
    order."""
    gen = generator(seed, tag, device)
    out = []
    for _ in range(batches):
        images, _ = lesions(gen, b, img, device)
        order = torch.argsort(torch.rand(b, generator=gen, device=device))
        domain = torch.arange(b, device=device) % domains
        out.append((images.float(), torch.eye(domains, device=device)[domain[order]]))
    return out
