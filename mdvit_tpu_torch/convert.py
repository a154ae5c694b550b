"""Carry ``mdvit_tpu`` model weights into the port.

``from_jax_variables(variables)`` takes the flax ``{'params', 'batch_stats'}``
tree of a ``mdvit_tpu`` MDViT or BASE (every registry model of the paper's
comparisons: Sup gate or none, shared or per-domain norms, the DASE and USE
adapters, the MLPFM, MLP, DeepLabV3 and Transformer debranches) as numpy
arrays, nested or flat with ``'/'``-joined keys (as saved in an ``.npz``),
and returns the port's ``state_dict``. It is the inverse of
``scripts/convert_reference_mdvit.py:torch_mdvit_to_flax`` (``dsn`` too):

* flax conv kernels HWIO → torch OIHW, flax dense (in, out) → torch (out, in);
* CRPE ``w3/w5/w7`` → ``crpe.conv_list.{0,1,2}``;
* the decoder's even/odd ``dwconv_kernel (k, k, 2, C)`` → the grouped conv
  weight (C, 2, k, k) of ``conv_after.dwconv``;
* the stacked ``debranch`` domain axis → ``debranch{1..D}``;
* a per-domain (D, C) norm leaf → ``bns.{d}`` / ``norm1s.{d}`` /
  ``norm2s.{d}`` / ``bridge_norms{1,2}.{d}``, and the DSN tree's stems and
  bridge convs → ``stem_{1,2}``, ``bridge_conv{1,2}``;
* BN ``mean/var`` → ``running_mean/running_var``;
* the adapters and the debranches' modules keep their flax names, by the
  trunk's rules (``decoder{n}_mhsa`` → ``decoder{n}.mhsa_block``).

Any key it does not map raises ``KeyError``.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}

# rewrites inside a module path, applied in order to '/'-joined flax paths
_INNER_RULES = [
    (r"(^|/)decoder(\d)_mhsa/", r"\1decoder\2/mhsa_block/"),
    (r"/block(\d+)/", r"/mhca_blks/\1/"),
    (r"/domain_layer_fc1/", "/domain_layer/0/"),
    (r"/domain_layer_fc2/", "/domain_layer/2/"),
    (r"/fuse_conv/", "/linear_fuse/0/"),
    (r"/fuse_bn/", "/linear_fuse/1/"),
    (r"/crpe/w3$", "/crpe/conv_list/0/kernel"),
    (r"/crpe/w5$", "/crpe/conv_list/1/kernel"),
    (r"/crpe/w7$", "/crpe/conv_list/2/kernel"),
    (r"/crpe/b3$", "/crpe/conv_list/0/bias"),
    (r"/crpe/b5$", "/crpe/conv_list/1/bias"),
    (r"/crpe/b7$", "/crpe/conv_list/2/bias"),
    (r"/conv_after/dwconv_kernel$", "/conv_after/dwconv/kernel"),
]
# the top of the path (``core/`` stripped): first match wins
_TOP_RULES = [
    (r"^patch_embed(\d)/", r"patch_embed_stages/\1/patch_conv/"),
    (r"^mhsa_stage(\d)/", r"mhsa_stages/\1/"),
    (r"^(decoder\d|enc_adapter\d|dec_adapter\d|bridge_adapter)/", r"\1/"),
    (r"^finalconv/", "finalconv/0/"),
    (r"^debranch/", "debranch{}/"),  # stacked: one module per domain
]
_SHARED_TOP = [
    (r"^stem(\d)/", lambda m: f"stem/{int(m[1]) - 1}/"),
    (r"^bridge_conv1/", "bridge/0/"),
    (r"^bridge_bn1/", "bridge/1/"),
    (r"^bridge_conv2/", "bridge/3/"),
    (r"^bridge_bn2/", "bridge/4/"),
]
_DSN_TOP = [  # the reference MDViT_DSN / BASE_DSN names (convert_reference_mdvit.py:229-298)
    (r"^stem(\d)/", r"stem_\1/"),
    (r"^bridge_conv(\d)/", r"bridge_conv\1/"),
    (r"^bridge_bn(\d)/", r"bridge_norms\1/"),
]
# a per-domain norm's module: its ModuleList of one norm a domain
_PER_DOMAIN = {"bn": "bns", "norm1": "norm1s", "norm2": "norm2s"}
_NORM_LEAVES = ("scale", "bias", "mean", "var")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _torch_name(path: str, dsn: bool = False) -> str:
    """flax path (no collection) → torch key; '{}' marks a debranch index.
    ``dsn``: the tree of a model with per-domain norms."""
    path = path.removeprefix("core/")
    for pat, repl in _INNER_RULES:
        path = re.sub(pat, repl, path)
    for pat, repl in (_DSN_TOP if dsn else _SHARED_TOP) + _TOP_RULES:
        new, n = re.subn(pat, repl, path, count=1)
        if n:
            break
    else:
        raise KeyError(f"no mapping for flax path {path!r}")
    mod, _, leaf = new.rpartition("/")
    if leaf not in _LEAF:
        raise KeyError(f"no mapping for flax leaf {path!r}")
    return f"{mod}/{_LEAF[leaf]}".replace("/", ".")


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.ndim == 4:  # conv kernel HWIO → OIHW
        arr = np.transpose(arr, (3, 2, 0, 1))
    elif arr.ndim == 2:  # dense kernel (in, out) → (out, in)
        arr = arr.T
    return torch.from_numpy(np.array(arr, np.float32, order="C"))  # a writable copy


def _is_dsn(flat: Mapping[str, np.ndarray]) -> bool:
    """Whether the trunk's norms are per domain: the first stem's BN leaves
    are (D, C)."""
    return any(re.search(r"core/stem1/bn/(scale|mean)$", k) and v.ndim == 2
               for k, v in flat.items())


def from_jax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax MDViT or BASE variables → the port's ``state_dict`` (fp32 tensors)."""
    flat = _flatten(variables)
    dsn = _is_dsn(flat)
    state: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        collection, _, path = key.partition("/")
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"no mapping for flax collection of {key!r}")
        name = _torch_name(path, dsn)
        parts = ([(name.format(d + 1), arr[d]) for d in range(arr.shape[0])]
                 if "{}" in name else [(name, arr)])
        for torch_name, a in parts:
            if path.rpartition("/")[2] in _NORM_LEAVES and a.ndim == 2:
                mod, _, leaf = torch_name.rpartition(".")
                head, _, last = mod.rpartition(".")
                mod = f"{head}.{_PER_DOMAIN.get(last, last)}".lstrip(".")
                for d in range(a.shape[0]):
                    state[f"{mod}.{d}.{leaf}"] = _to_torch(a[d])
            else:
                state[torch_name] = _to_torch(a)
    return state
