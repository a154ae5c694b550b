"""Batch inference with the port: segment images with a model's primary head.

Counterpart of ``scripts/predict.py``. Preprocessing matches the eval
pipeline: half-pixel bilinear resize to the model's resolution, then norm01
and ImageNet normalisation on the device. Every micro-batch has the same
``--batch_size`` (the last one is padded), so each forward sees one shape.

Usage::

    python -m mdvit_tpu_torch.predict (--weights W.pt | --ckpt_dir EXP) \\
        --inputs img1.npy img2.png some_dir/ --out_dir preds --domain 2 \\
        [--batch_size 8] [--threshold 0.5] [--save_prob] [--dtype bfloat16] \\
        [--device cpu]

``W.pt`` is a file written by ``mdvit_tpu_torch.models.registry.save_weights``;
``EXP`` an experiment dir of the port's trainer, whose best checkpoint is
restored into the model its ``exp_config.yml`` describes (the counterpart of
``scripts/predict.py --ckpt_dir``).
"""
from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from mdvit_tpu_torch.data.preprocess import normalize, resize_bilinear_np
from mdvit_tpu_torch.device import deterministic, no_tf32
from mdvit_tpu_torch.models.base import split_seg
from mdvit_tpu_torch.utils.spans import span

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".npy")


def gather_inputs(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(os.path.join(p, f) for f in sorted(os.listdir(p))
                         if f.lower().endswith(IMG_EXTS))
        else:
            files.append(p)
    if not files:
        raise SystemExit("predict: no input images found")
    return files


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 on the 0..255 scale."""
    if path.lower().endswith(".npy"):
        arr = np.load(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    if arr.max() <= 1.0 + 1e-6:  # float images stored on 0..1
        arr = arr * 255.0
    return arr


def save_mask(path_base: str, mask: np.ndarray, prob: np.ndarray | None) -> None:
    try:
        from PIL import Image
    except ImportError:
        np.save(path_base + "_mask.npy", mask)
    else:
        Image.fromarray(mask * np.uint8(255)).save(path_base + "_mask.png")
    if prob is not None:
        np.save(path_base + "_prob.npy", prob)


class Serving(torch.nn.Module):
    """``(images 0..255 NHWC f32, onehot (B, D) f32) → sigmoid probability
    maps (B, H, W)`` from the primary head of any ported model: the eval
    preprocessing, the eval-mode forward without debranches, the sigmoid.
    ``make_forward`` runs it; ``export`` exports it."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        out = self.model(normalize(x), onehot, train=False, aux_mode="none")
        return torch.sigmoid(split_seg(out["seg"])[0].float())[..., 0]


def make_forward(model: torch.nn.Module) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``Serving(model)`` as a function, as ``scripts/predict.py:make_forward``.
    Runs without autograd, with TF32 off (``no_tf32``) and deterministic
    (``deterministic``), whatever the caller's flags say; a call is the span
    ``mdvit.serve`` (``utils.spans``), outside ``Serving``, which
    ``torch.export`` traces."""
    serve = Serving(model)

    @torch.no_grad()
    @no_tf32()
    @deterministic()
    def forward(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        with span("mdvit.serve"):
            return serve(x, onehot)

    return forward


def load_experiment(ckpt_dir: str, device: str | torch.device,
                    dtype: torch.dtype | None = None,
                    config_yml: str | None = None) -> torch.nn.Module:
    """The model of a trainer experiment dir with its best checkpoint,
    rebuilt from ``exp_config.yml`` (or ``config_yml``), in eval mode."""
    from mdvit_tpu_torch.config import load_config
    from mdvit_tpu_torch.device import resolve_device
    from mdvit_tpu_torch.train import checkpoints as ckpt
    from mdvit_tpu_torch.train.trainer import build_model_from_config

    config = load_config(config_yml or os.path.join(ckpt_dir, "exp_config.yml"))
    if dtype is not None:
        config.tpu.compute_dtype = str(dtype).replace("torch.", "")
    model = build_model_from_config(config, resolve_device(device))
    model.load_state_dict(ckpt.load_best(ckpt_dir)["model"])
    model.config = {"img_size": int(config.data.img_size),
                    "num_domains": int(config.model_adapt.num_domains)}
    return model.eval()


def main(argv: list[str] | None = None) -> None:
    from mdvit_tpu_torch.models.registry import load_weights

    ap = argparse.ArgumentParser(description="mdvit_tpu_torch batch inference")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="file from save_weights")
    src.add_argument("--ckpt_dir",
                     help="trainer experiment dir (best.pt + exp_config.yml)")
    ap.add_argument("--config_yml", default=None,
                    help="config override for --ckpt_dir (default: its exp_config.yml)")
    ap.add_argument("--inputs", nargs="+", required=True,
                    help="image files (.npy/.png/.jpg/.bmp) and/or directories")
    ap.add_argument("--out_dir", default="predictions")
    ap.add_argument("--domain", type=int, default=0,
                    help="domain index for the Sup gate's one-hot")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--save_prob", action="store_true",
                    help="also save the sigmoid probability map as .npy")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="compute dtype (default: the weight file's or the config's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dtype = getattr(torch, args.dtype) if args.dtype else None
    if args.ckpt_dir:
        model = load_experiment(args.ckpt_dir, args.device, dtype, args.config_yml)
    else:
        model = load_weights(args.weights, device=args.device, dtype=dtype)
    device = next(model.parameters()).device
    img_size = int(model.config["img_size"])
    num_domains = int(model.config["num_domains"])
    if not 0 <= args.domain < num_domains:
        raise SystemExit(f"--domain {args.domain} out of range for a "
                         f"{num_domains}-domain model")
    bs = max(1, args.batch_size)
    onehot = torch.zeros((bs, num_domains), device=device)
    onehot[:, args.domain] = 1.0
    forward = make_forward(model)

    files = gather_inputs(args.inputs)
    os.makedirs(args.out_dir, exist_ok=True)
    n_done = 0
    seen: dict[str, int] = {}
    for start in range(0, len(files), bs):
        chunk = files[start:start + bs]
        batch = np.zeros((bs, img_size, img_size, 3), np.float32)
        for i, f in enumerate(chunk):
            batch[i] = np.clip(resize_bilinear_np(load_image(f), img_size), 0.0, 255.0)
        probs = forward(torch.from_numpy(batch).to(device), onehot).cpu().numpy()
        for i, f in enumerate(chunk):
            stem = os.path.splitext(os.path.basename(f))[0]
            n = seen.get(stem, 0)  # same basename from two directories
            seen[stem] = n + 1
            if n:
                stem = f"{stem}_{n + 1}"
            mask = (probs[i] > args.threshold).astype(np.uint8)
            save_mask(os.path.join(args.out_dir, stem), mask,
                      probs[i] if args.save_prob else None)
            n_done += 1
        print(f"predicted {n_done}/{len(files)}", flush=True)
    print(f"wrote {n_done} masks to {args.out_dir}")


if __name__ == "__main__":
    main()
