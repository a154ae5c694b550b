"""ImageNet backbones grafted into TransFuse (``mdvit_tpu/train/pretrained.py``).

The reference always builds TransFuse from ImageNet checkpoints: torchvision
``resnet34``/``resnet50`` and timm DeiT, merged with the partial state-dict
loader ``load_pretrain`` (take a tensor only where the name and the shape
match). The port does it in two steps, as JAX does:

1. once, offline: ``python -m mdvit_tpu_torch.convert_torch_weights`` turns
   a local torchvision or timm checkpoint into ``<arch>.pt`` in the port's
   names (the DeiT position embedding without its cls row, resized to a
   token grid);
2. when a model is built: ``apply_pretrained`` grafts those files from the
   ``pretrained_folder`` config key into a freshly built TransFuse and
   returns a matched/total report. The DeiT position embedding is resized
   again (align-corners bilinear) when the model's own grid differs from
   the file's: the grid is the model's (``TransFuse_L_384`` pins 384×512),
   not the config's.

Other models, and a folder without the files, are no-ops.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

# registry name → (file stem of the CNN branch, of the ViT branch); the stems
# are the converter's --arch values
TRANSFUSE_BACKBONES = {
    "TransFuse_S": ("resnet34", "deit_small"),
    "TransFuse_S_adapt": ("resnet34", "deit_small"),
    "TransFuse_L": ("resnet50", "deit_base"),
    "TransFuse_L_384": ("resnet50", "deit_base"),
}


def resize_grid_pos_embed(pe: np.ndarray, src_hw: Sequence[int],
                          dst_hw: Sequence[int]) -> np.ndarray:
    """Align-corners bilinear resize of a cls-free position embedding
    (1, N, C) from the grid ``src_hw`` to ``dst_hw``
    (``pretrained.py:resize_grid_pos_embed``)."""
    sh, sw = src_hw
    gh, gw = dst_hw
    c = pe.shape[2]
    img = np.asarray(pe).reshape(sh, sw, c)
    if (sh, sw) == (gh, gw):
        return img.reshape(1, gh * gw, c)
    ys = np.linspace(0, sh - 1, gh) if gh > 1 else np.zeros(1)
    xs = np.linspace(0, sw - 1, gw) if gw > 1 else np.zeros(1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    return out.reshape(1, gh * gw, c).astype(pe.dtype)


def _find(folder: str, stem: str) -> str | None:
    for ext in (".pt", ""):
        path = os.path.join(folder, stem + ext)
        if os.path.isfile(path):
            return path
    return None


def _merge(model: torch.nn.Module, prefix: str, tensors: dict, matched: list,
           skipped: list) -> None:
    """``load_pretrain``'s partial merge into ``model`` under ``prefix``: a
    tensor is taken where the model has its name and shape."""
    state = model.state_dict()
    with torch.no_grad():
        for name, t in tensors.items():
            key = f"{prefix}.{name}"
            if key in state and tuple(state[key].shape) == tuple(t.shape):
                state[key].copy_(t)
                matched.append(key)
            else:
                skipped.append(key)


def apply_pretrained(model: torch.nn.Module, model_name: str, folder: str) -> str | None:
    """Graft the converted backbones of ``model_name`` found in ``folder``
    into ``model`` in place; returns the report, or None when ``model_name``
    is not of the TransFuse family or ``folder`` is empty."""
    stems = TRANSFUSE_BACKBONES.get(model_name)
    if stems is None or not folder:
        return None
    resnet_stem, deit_stem = stems
    grid = tuple(model.transformer.grid)
    matched: list = []
    skipped: list = []
    used = []
    path = _find(folder, resnet_stem)
    if path is not None:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        _merge(model, "resnet", blob["state_dict"], matched, skipped)
        used.append(os.path.basename(path))
    path = _find(folder, deit_stem)
    if path is not None:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        tensors = dict(blob["state_dict"])
        pe = tensors.get("pos_embed")
        if pe is not None and pe.shape[1] != grid[0] * grid[1]:
            src = tuple(int(s) for s in blob.get("grid") or [int(np.sqrt(pe.shape[1]))] * 2)
            tensors["pos_embed"] = torch.from_numpy(
                resize_grid_pos_embed(pe.numpy(), src, grid))
            print(f"[pretrained] pos_embed re-resized {src}→{grid}; convert with "
                  f"--grid {grid[0]} {grid[1]} for single-pass resize parity")
        _merge(model, "transformer", tensors, matched, skipped)
        used.append(os.path.basename(path))
    if not used:
        return (f"[pretrained] no {resnet_stem}/{deit_stem} files in {folder}; "
                "training from random init")
    return (f"[pretrained] loaded {', '.join(used)}: {len(matched)} tensors grafted, "
            f"{len(skipped)} skipped")
