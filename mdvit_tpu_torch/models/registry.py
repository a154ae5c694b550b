"""Model construction and weight files (``mdvit_tpu/models/registry.py``).

``build_model(name, ...)`` builds the models of the paper's comparisons by
their registry names, with the JAX builders' arguments: the family
(``base.py:239-274``, ``mdvit.py:231-251``) with dropout and stochastic
depth 0.1 and the Sup gate when ``adapt_method`` names it; the segmentation
comparators (``swin_unet.py``, ``swin_unetr.py``, ``utnet.py``,
``transfuse.py``) and the classifiers (Swin, MPViT, CoaT and CoaT-Lite,
``{"logits", "feat"}`` at 224² and 1000 classes) with their own modules'
defaults, whatever ``adapt_method`` says (``TransFuse_S_adapt`` always has
the gate). ``save_weights`` records the name, and ``load_weights`` rebuilds
whatever it names.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from mdvit_tpu_torch.device import resolve_device
from mdvit_tpu_torch.models import coat, mpvit
from mdvit_tpu_torch.models.base import BASE
from mdvit_tpu_torch.models.mdvit import MDViT
from mdvit_tpu_torch.models.swin_unet import SwinClassifier, SwinUnet
from mdvit_tpu_torch.models.swin_unetr import SwinUNETR
from mdvit_tpu_torch.models.transfuse import TransFuse
from mdvit_tpu_torch.models.utnet import UTNet
from mdvit_tpu_torch.ops.initializers import init_weights_

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


def _zoo(cls: type, sized: bool = True, domains: bool = False,
         **defaults: Any) -> Callable[..., nn.Module]:
    """A comparator's builder: ``cls`` with the JAX builder's ``defaults``
    (``kw`` overrides them); ``sized``: it takes ``img_size``; ``domains``:
    it takes ``num_domains``. ``decoder_name`` is dropped, as JAX drops it."""
    def build(img_size: Any, adapt_method: Any, num_domains: int, **kw: Any) -> nn.Module:
        kw.pop("decoder_name", None)
        if sized:
            kw.setdefault("img_size", img_size)
        if domains:
            kw["num_domains"] = num_domains
        return cls(**{**defaults, **kw})
    return build


# adapter comparators take no Sup gate, whatever adapt_method says
BUILDERS: dict[str, Callable[..., nn.Module]] = {
    "MDViT": _mdvit(),
    "MDViT_DSN": _mdvit(dsn=True),
    "BASE": _base(),
    "BASE_DSN": _base(dsn=True),
    "BASE_DASE": _base(adapt=None, adapter="DASE"),
    "BASE_USE": _base(adapt=None, adapter="USE"),
    "SwinUnet": _zoo(SwinUnet, window=8),
    "swin_tiny": _zoo(SwinClassifier),
    "SwinUNETR": _zoo(SwinUNETR),
    "UTNet": _zoo(UTNet, sized=False),
    "TransFuse_S": _zoo(TransFuse, domains=True, variant="S", sup=False),
    "TransFuse_S_adapt": _zoo(TransFuse, domains=True, variant="S", sup=True),
    "TransFuse_L": _zoo(TransFuse, domains=True, variant="L", sup=False),
    # pinned to the reference's 384×512 input, a (24, 32) DeiT grid, whatever
    # img_size says (transfuse.py:473-485)
    "TransFuse_L_384": _zoo(TransFuse, sized=False, domains=True, img_size=(384, 512),
                            variant="L", sup=False),
    # the MPViT and CoaT classifiers: MPViT's stochastic depth 0, CoaT has none
    **{name: _zoo(mpvit.MPViT, sized=False, **cfg) for name, cfg in mpvit.CONFIGS.items()},
    **{name: _zoo(coat.CoaT, sized=False, **cfg) for name, cfg in coat.CONFIGS.items()},
}
# the models whose output is {"logits", "feat"}, not a segmentation
CLASSIFIERS = ("swin_tiny", *mpvit.CONFIGS, *coat.CONFIGS)
# the family's dropout and stochastic depth (the reference trainers' 0.1);
# the comparators keep their modules' own
FAMILY_DROPS = {"drop_rate": 0.1, "drop_path_rate": 0.1}
FAMILY = ("MDViT", "MDViT_DSN", "BASE", "BASE_DSN", "BASE_DASE", "BASE_USE")
# the default adapt_method and img_size of each builder's JAX signature
DEFAULT_ADAPT = {"MDViT": "Sup", "MDViT_DSN": "Sup", "TransFuse_S_adapt": "Sup"}
DEFAULT_IMG = {name: 224 for name in CLASSIFIERS}
_BUILDER_DEFAULT = object()


def build_model(name: str, img_size: int | None = None, num_domains: int = 4,
                adapt_method: Any = _BUILDER_DEFAULT, dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None, seed: int = 0,
                drop_rate: float | None = None, drop_path_rate: float | None = None,
                **kw: Any) -> nn.Module:
    """The registry model ``name``, weights drawn from ``seed``, in eval mode
    on ``device`` (``cuda`` unless told otherwise). ``img_size`` defaults to
    the JAX builder's (256; 224 for the classifiers). Dropout and stochastic
    depth default to the reference trainers' 0.1 for the family and to the
    modules' own for the comparators; they act in train mode only.
    ``adapt_method`` defaults to the JAX builder's (Sup for MDViT, none for
    BASE). ``kw`` passes widths and depths (``num_layers``, ``embed_dims``,
    ``mlp_ratios``, ``num_heads``; a comparator's own fields, e.g.
    ``embed_dim``, ``window``, ``base_chan``) and MDViT's ``decoder_name``;
    ``model.config`` records every argument, so ``load_weights`` can rebuild
    the model."""
    if name not in BUILDERS:
        raise KeyError(f"unknown model {name!r}; have {sorted(BUILDERS)}")
    if adapt_method is _BUILDER_DEFAULT:
        adapt_method = DEFAULT_ADAPT.get(name)
    if img_size is None:
        img_size = DEFAULT_IMG.get(name, 256)
    dev = resolve_device(device)
    drops = {k: v for k, v in (("drop_rate", drop_rate), ("drop_path_rate", drop_path_rate))
             if v is not None}
    kw = {**(FAMILY_DROPS if name in FAMILY else {}), **drops, **kw}
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


def require_segmenter(name: str) -> None:
    """Raise ``ValueError`` for a classifier: the training and eval paths
    segment (JAX's trainer cannot train a classifier either)."""
    if name in CLASSIFIERS:
        raise ValueError(f"model {name!r} is a classifier (its output is logits and "
                         "feat, no segmentation): the Trainer trains segmentation models")


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
    try:
        model = build_model(name, dtype=dtype or cfg_dtype, device="cpu", **cfg)
        model.load_state_dict(blob["state_dict"])
    except (TypeError, RuntimeError) as err:  # a config or weights of another model
        raise ValueError(f"{path}: the file's config and weights do not build "
                         f"{name!r}: {err}") from err
    model.config["dtype"] = str(dtype or cfg_dtype).replace("torch.", "")
    return model.to(resolve_device(device)).eval()
