"""Carry ``mdvit_tpu`` MDViT weights into the port.

``from_jax_variables(variables)`` takes the flax ``{'params', 'batch_stats'}``
tree of ``mdvit_tpu.models.mdvit.MDViT`` (Sup gate, MLPFM debranch, shared
norms) as numpy arrays, nested or flat with ``'/'``-joined keys (as saved in
an ``.npz``), and returns the port's ``state_dict``. It is the inverse of
``scripts/convert_reference_mdvit.py:torch_mdvit_to_flax``:

* flax conv kernels HWIO → torch OIHW, flax dense (in, out) → torch (out, in);
* CRPE ``w3/w5/w7`` → ``crpe.conv_list.{0,1,2}``;
* the decoder's even/odd ``dwconv_kernel (k, k, 2, C)`` → the grouped conv
  weight (C, 2, k, k) of ``conv_after.dwconv``;
* the stacked ``debranch`` domain axis → ``debranch{1..D}``;
* BN ``mean/var`` → ``running_mean/running_var``.

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
# the top of the path: first match wins
_TOP_RULES = [
    (r"^core/stem(\d)/", lambda m: f"stem/{int(m[1]) - 1}/"),
    (r"^core/patch_embed(\d)/", r"patch_embed_stages/\1/patch_conv/"),
    (r"^core/mhsa_stage(\d)/", r"mhsa_stages/\1/"),
    (r"^core/decoder(\d)_mhsa/", r"decoder\1/mhsa_block/"),
    (r"^core/decoder(\d)/", r"decoder\1/"),
    (r"^core/bridge_conv1/", "bridge/0/"),
    (r"^core/bridge_bn1/", "bridge/1/"),
    (r"^core/bridge_conv2/", "bridge/3/"),
    (r"^core/bridge_bn2/", "bridge/4/"),
    (r"^finalconv/", "finalconv/0/"),
    (r"^debranch/", "debranch{}/"),  # stacked: one module per domain
]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _torch_name(path: str) -> str:
    """flax path (no collection) → torch key; '{}' marks a debranch index."""
    for pat, repl in _INNER_RULES:
        path = re.sub(pat, repl, path)
    for pat, repl in _TOP_RULES:
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


def from_jax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax MDViT variables → the port's ``state_dict`` (fp32 tensors)."""
    state: dict[str, torch.Tensor] = {}
    for key, arr in _flatten(variables).items():
        collection, _, path = key.partition("/")
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"no mapping for flax collection of {key!r}")
        name = _torch_name(path)
        if "{}" in name:
            for d in range(arr.shape[0]):
                state[name.format(d + 1)] = _to_torch(arr[d])
        else:
            state[name] = _to_torch(arr)
    return state
