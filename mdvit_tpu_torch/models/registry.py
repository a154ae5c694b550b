"""Model construction and weight files (``mdvit_tpu/models/registry.py``).

``build_model(name, ...)`` builds the models of the paper's comparisons by
their registry names, with the JAX builders' arguments (``base.py:239-274``,
``mdvit.py:231-251``): dropout and stochastic depth 0.1, the Sup gate when
``adapt_method`` names it. ``save_weights`` records the name, and
``load_weights`` rebuilds whatever it names.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from mdvit_tpu_torch.device import resolve_device
from mdvit_tpu_torch.models.base import BASE
from mdvit_tpu_torch.models.mdvit import MDViT
from mdvit_tpu_torch.ops.initializers import init_weights_

# the JAX package's other registered models, not ported: ROADMAP queue A item 8
UNPORTED = ("SwinUnet", "swin_tiny", "SwinUNETR", "UTNet", "TransFuse_S",
            "TransFuse_S_adapt", "TransFuse_L", "TransFuse_L_384", "mpvit_tiny",
            "mpvit_xsmall", "mpvit_small", "mpvit_base", "coat_tiny", "coat_mini",
            "coat_small", "coat_lite_tiny", "coat_lite_mini", "coat_lite_small")


def _sup(adapt_method: Any) -> str | None:
    return "Sup" if adapt_method and "Sup" in str(adapt_method) else None


def _base(**fixed: Any) -> Callable[..., nn.Module]:
    def build(img_size: int, adapt_method: Any, **kw: Any) -> nn.Module:
        return BASE(**{"adapt": _sup(adapt_method), **fixed, **kw})
    return build


def _mdvit(**fixed: Any) -> Callable[..., nn.Module]:
    def build(img_size: int, adapt_method: Any, **kw: Any) -> nn.Module:
        return MDViT(img_size=img_size, adapt=_sup(adapt_method), **fixed, **kw)
    return build


# adapter comparators take no Sup gate, whatever adapt_method says
BUILDERS: dict[str, Callable[..., nn.Module]] = {
    "MDViT": _mdvit(),
    "MDViT_DSN": _mdvit(dsn=True),
    "BASE": _base(),
    "BASE_DSN": _base(dsn=True),
    "BASE_DASE": _base(adapt=None, adapter="DASE"),
    "BASE_USE": _base(adapt=None, adapter="USE"),
}
# the default adapt_method of each builder's JAX signature
DEFAULT_ADAPT = {"MDViT": "Sup", "MDViT_DSN": "Sup"}
_BUILDER_DEFAULT = object()


def build_model(name: str, img_size: int = 256, num_domains: int = 4,
                adapt_method: Any = _BUILDER_DEFAULT, dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None, seed: int = 0,
                drop_rate: float = 0.1, drop_path_rate: float = 0.1,
                **kw: Any) -> nn.Module:
    """The registry model ``name``, weights drawn from ``seed``, in eval mode
    on ``device`` (``cuda`` unless told otherwise). Dropout and stochastic
    depth default to the reference trainers' 0.1; they act in train mode
    only. ``adapt_method`` defaults to the JAX builder's (Sup for MDViT,
    none for BASE). ``kw`` passes widths and depths (``num_layers``,
    ``embed_dims``, ``mlp_ratios``, ``num_heads``) and MDViT's
    ``decoder_name``; ``model.config`` records every argument, so
    ``load_weights`` can rebuild the model."""
    if name in UNPORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported: the comparator zoo is ROADMAP queue A item 8")
    if name not in BUILDERS:
        raise KeyError(f"unknown model {name!r}; have {sorted(BUILDERS)}")
    if adapt_method is _BUILDER_DEFAULT:
        adapt_method = DEFAULT_ADAPT.get(name)
    dev = resolve_device(device)
    kw = {"drop_rate": drop_rate, "drop_path_rate": drop_path_rate, **kw}
    with torch.device(dev):  # the modules' own init runs where they live
        model = BUILDERS[name](img_size=img_size, adapt_method=adapt_method,
                               num_domains=num_domains, dtype=dtype, **kw)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model.config = {"name": name, "img_size": img_size, "num_domains": num_domains,
                    "adapt_method": adapt_method,
                    "dtype": str(dtype).replace("torch.", ""), **kw}
    return model.eval()


def build_mdvit(img_size: int = 256, num_domains: int = 4,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None, seed: int = 0,
                drop_rate: float = 0.1, drop_path_rate: float = 0.1,
                **kw: Any) -> MDViT:
    """The flagship: MDViT with the Sup gate and MLPFM debranches
    (``build_model("MDViT", ...)``)."""
    return build_model("MDViT", img_size, num_domains, "Sup", dtype, device, seed,
                       drop_rate, drop_path_rate, **kw)


def save_weights(path: str, model: nn.Module) -> None:
    """Write ``{"model": name, "config", "state_dict"}`` with torch.save."""
    torch.save({"model": model.config["name"], "config": model.config,
                "state_dict": model.state_dict()}, path)


def load_weights(path: str, device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None) -> nn.Module:
    """Rebuild the model a ``save_weights`` file names and load it;
    ``dtype`` overrides the compute dtype it was saved with."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    cfg = dict(blob["config"])
    name = cfg.pop("name", "MDViT")  # files of the flagship-only port name none
    if blob.get("model") != name or name not in BUILDERS:
        raise ValueError(f"{path}: not a weight file of a ported model "
                         f"({blob.get('model')!r})")
    cfg_dtype = getattr(torch, cfg.pop("dtype"))
    model = build_model(name, dtype=dtype or cfg_dtype, device="cpu", **cfg)
    model.load_state_dict(blob["state_dict"])
    model.config["dtype"] = str(dtype or cfg_dtype).replace("torch.", "")
    return model.to(resolve_device(device)).eval()
