"""The system under test, ``mdvit_tpu_torch``, built through its registry."""
from __future__ import annotations

import torch


def build(cfg: dict, device) -> torch.nn.Module:
    """The configuration's model from the system's registry, with no
    weights drawn (the benchmark's are loaded into it), in eval mode (the
    steps pass ``train`` themselves)."""
    from mdvit_tpu_torch.models.registry import BUILDERS

    widths = {k: tuple(cfg[k]) for k in ("embed_dims", "num_layers", "mlp_ratios", "num_heads")}
    with torch.device("meta"):
        model = BUILDERS[cfg["model"]](img_size=cfg["img_size"], adapt_method=cfg["adapt_method"],
                                       num_domains=cfg["num_domains"], dtype=torch.float32,
                                       drop_rate=cfg["drop_rate"],
                                       drop_path_rate=cfg["drop_path_rate"], **widths)
    return model.to_empty(device=device).eval()
