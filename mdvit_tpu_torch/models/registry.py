"""Model construction and weight files (``mdvit_tpu/models/registry.py``)."""
from __future__ import annotations

from typing import Any

import torch

from mdvit_tpu_torch.device import resolve_device
from mdvit_tpu_torch.models.mdvit import MDViT
from mdvit_tpu_torch.ops.initializers import init_weights_


def build_mdvit(img_size: int = 256, num_domains: int = 4,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None, seed: int = 0,
                drop_rate: float = 0.1, drop_path_rate: float = 0.1,
                **kw: Any) -> MDViT:
    """MDViT with the Sup gate and MLPFM debranches, weights drawn from
    ``seed``, in eval mode on ``device`` (``cuda`` unless told otherwise).
    Dropout and stochastic depth default to the reference trainer's 0.1
    (``mdvit_tpu/models/mdvit.py:build_mdvit``); they act in train mode only.

    ``kw`` passes model widths and depths (``num_layers``, ``embed_dims``,
    ``mlp_ratios``, ``num_heads``); ``model.config`` records every argument,
    so ``load_weights`` can rebuild the model."""
    dev = resolve_device(device)
    kw = {"drop_rate": drop_rate, "drop_path_rate": drop_path_rate, **kw}
    model = MDViT(img_size=img_size, num_domains=num_domains, dtype=dtype, **kw)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model.config = {"img_size": img_size, "num_domains": num_domains,
                    "dtype": str(dtype).replace("torch.", ""), **kw}
    return model.to(dev).eval()


def save_weights(path: str, model: MDViT) -> None:
    """Write ``{"model": "MDViT", "config", "state_dict"}`` with torch.save."""
    torch.save({"model": "MDViT", "config": model.config,
                "state_dict": model.state_dict()}, path)


def load_weights(path: str, device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None) -> MDViT:
    """Rebuild the model a ``save_weights`` file describes and load it;
    ``dtype`` overrides the compute dtype it was saved with."""
    dev = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if blob.get("model") != "MDViT":
        raise ValueError(f"{path}: not an MDViT weight file")
    cfg = dict(blob["config"])
    cfg_dtype = getattr(torch, cfg.pop("dtype"))
    model = MDViT(dtype=dtype or cfg_dtype, **cfg)
    model.load_state_dict(blob["state_dict"])
    model.config = {**cfg, "dtype": str(dtype or cfg_dtype).replace("torch.", "")}
    return model.to(dev).eval()
