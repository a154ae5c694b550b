"""Convert a local torchvision or timm checkpoint into a TransFuse backbone
file of the port (the counterpart of ``scripts/convert_torch_weights.py``).

torchvision ``resnet34``/``resnet50`` (through layer3) and timm
``deit_small``/``deit_base`` state dicts map onto the port's
``models/transfuse.py`` names; the tensors keep their torch layouts. The DeiT
position embedding loses its cls row and is resized (align-corners
bilinear) to ``--grid``; the cls token, the head and layer4 are not used.
Nothing is downloaded: ``--ckpt`` is a file on disk (a state dict, or a
dict holding one under ``model`` or ``state_dict``).

Usage::

    python -m mdvit_tpu_torch.convert_torch_weights --arch resnet34 \\
        --ckpt resnet34-333f7ec4.pth --out_dir pretrained
    python -m mdvit_tpu_torch.convert_torch_weights --arch deit_small \\
        --ckpt deit_small_patch16_224-cd65a155.pth --out_dir pretrained --grid 16 16

It writes ``<out_dir>/<arch>.pt``, the file ``train.pretrained`` reads from
the ``pretrained_folder`` config key.
"""
from __future__ import annotations

import argparse
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from mdvit_tpu_torch.train.pretrained import resize_grid_pos_embed

ARCHS = ("resnet34", "resnet50", "deit_small", "deit_base")
# the DeiT blocks TransFuse keeps (deit_small: 8 of its 12)
DEIT_DEPTH = {"deit_small": 8, "deit_base": 12}
_BN = ("weight", "bias", "running_mean", "running_var")


def convert_resnet(sd: Mapping[str, torch.Tensor], arch: str = "resnet34"
                   ) -> dict[str, torch.Tensor]:
    """torchvision resnet → ``ResNetStem3Stages`` tensors (names under
    ``resnet.``)."""
    out = {"conv1.weight": sd["conv1.weight"]}
    out.update({f"bn1.{k}": sd[f"bn1.{k}"] for k in _BN})
    convs = 3 if arch == "resnet50" else 2
    for li, n in enumerate((3, 4, 6), start=1):
        for bi in range(n):
            src, dst = f"layer{li}.{bi}", f"layer{li}_{bi}"
            for ci in range(1, convs + 1):
                out[f"{dst}.conv{ci}.weight"] = sd[f"{src}.conv{ci}.weight"]
                out.update({f"{dst}.bn{ci}.{k}": sd[f"{src}.bn{ci}.{k}"] for k in _BN})
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.down_conv.weight"] = sd[f"{src}.downsample.0.weight"]
                out.update({f"{dst}.down_bn.{k}": sd[f"{src}.downsample.1.{k}"]
                            for k in _BN})
    return out


def resize_pos_embed(pe: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """A timm position embedding (1, 1 + s², C) without its cls row, resized
    from its square grid to ``grid`` (gh, gw)."""
    pe = pe[:, 1:, :].numpy()
    side = int(np.sqrt(pe.shape[1]))
    return torch.from_numpy(resize_grid_pos_embed(pe, (side, side), tuple(grid)))


def convert_deit(sd: Mapping[str, torch.Tensor], grid: Sequence[int], depth: int
                 ) -> dict[str, torch.Tensor]:
    """timm deit → ``DeiT`` tensors (names under ``transformer.``)."""
    out = {"patch_embed.weight": sd["patch_embed.proj.weight"],
           "patch_embed.bias": sd["patch_embed.proj.bias"],
           "pos_embed": resize_pos_embed(sd["pos_embed"], grid)}
    for i in range(depth):  # blocks.i.attn.qkv → block{i}_attn.qkv, ...
        for mod in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"block{i}_{mod}.{leaf}"] = sd[f"blocks.{i}.{mod}.{leaf}"]
    out["norm.weight"], out["norm.bias"] = sd["norm.weight"], sd["norm.bias"]
    return out


def convert(arch: str, sd: Mapping[str, torch.Tensor], grid: Sequence[int] = (16, 16)
            ) -> dict:
    """The backbone file's contents for ``arch``: ``{"arch", "state_dict"}``
    and, for a DeiT, the ``grid`` its position embedding was resized to."""
    sd = {k: v.detach().float().cpu() for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if arch.startswith("resnet"):
        return {"arch": arch, "state_dict": convert_resnet(sd, arch)}
    grid = [int(g) for g in grid]
    return {"arch": arch, "grid": grid,
            "state_dict": convert_deit(sd, grid, DEIT_DEPTH[arch])}


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description="torchvision/timm checkpoint → a "
                                 "TransFuse backbone file of mdvit_tpu_torch")
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--ckpt", required=True, help="a local .pth state dict")
    ap.add_argument("--grid", type=int, nargs="+", default=[16],
                    help="DeiT token grid: one side, or height and width (24 32 "
                    "for TransFuse_L_384)")
    ap.add_argument("--out_dir", default=".",
                    help="the pretrained_folder; the file is <out_dir>/<arch>.pt")
    args = ap.parse_args(argv)
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    grid = args.grid * 2 if len(args.grid) == 1 else args.grid[:2]
    blob = convert(args.arch, sd, grid)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"{args.arch}.pt")
    torch.save(blob, out)
    print(f"wrote {out}: {len(blob['state_dict'])} tensors")
    return out


if __name__ == "__main__":
    main()
