"""Weights from the seed, made on the device in one draw.

The published model's initialisation: a conv's weight normal(0, √(2 /
fan_out)), fan_out = k_h·k_w·out / groups; a linear's normal(0, 0.02);
biases 0; norms' weight 1 and bias 0; running mean 0 and variance 1. The
names and shapes come from the plain reference's module tree, whose
``state_dict`` names are the system's. The serving cell's BatchNorm
statistics are then set as a trained model's hold them: the moments of a
calibration batch, taken by the plain reference (``calibrated``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from portbench import data
from portbench.reference import train as ref_train
from portbench.reference.model import Ctx


def _std(module: nn.Module) -> float | None:
    if isinstance(module, nn.Conv2d):
        kh, kw = module.kernel_size
        return math.sqrt(2.0 / (kh * kw * module.out_channels // module.groups))
    if isinstance(module, nn.Linear):
        return 0.02
    return None


def make_state(model: nn.Module, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """A state dict for ``model``'s names (fp32, on ``device``), every
    random weight a slice of one ``torch.randn`` drawn from ``gen``."""
    drawn = []
    for mname, m in model.named_modules():
        std = _std(m)
        if std is not None:
            drawn.append((f"{mname}.weight" if mname else "weight", m.weight.shape, std))
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    state, off = {}, 0
    for name, shape, std in drawn:
        n = math.prod(shape)
        state[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for name, t in model.state_dict().items():
        if name in state:
            continue
        fill = 1.0 if name.endswith("running_var") or (
            name.endswith(".weight") and t.dim() == 1) else 0.0
        state[name] = torch.full(t.shape, fill, device=device)
    return state


def from_seed(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The configuration's weights for the run ``seed``."""
    with torch.device("meta"):
        shell = ref_train.build(cfg)
    return make_state(shell, data.generator(seed, data.WEIGHTS, device), device)


@torch.no_grad()
def calibrated(model: nn.Module, images: torch.Tensor, onehot: torch.Tensor,
               normalize) -> dict[str, torch.Tensor]:
    """``model``'s state dict after its BatchNorms took the moments of one
    forward over ``images`` (0..255 NHWC): ``model`` holds the weights."""
    model(normalize(images), onehot, Ctx(calibrate=True))
    return {k: v.clone() for k, v in model.state_dict().items()}
