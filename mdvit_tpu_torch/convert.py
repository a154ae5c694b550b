"""Carry ``mdvit_tpu`` model weights into the port.

``from_jax_variables(variables)`` takes the flax ``{'params', 'batch_stats'}``
tree of a ``mdvit_tpu`` model (an MDViT or BASE of the paper's family: Sup
gate or none, shared or per-domain norms, the DASE and USE adapters, the
MLPFM, MLP, DeepLabV3 and Transformer debranches; or a comparator) as numpy
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

The comparators (SwinUnet, the Swin classifier, SwinUNETR, UTNet, the
TransFuse family; a tree whose top holds ``patch_embed``, ``inc0``,
``transformer`` or ``resnet``) keep the flax module names in the port, so their paths map
as they are, '/' → '.', with the leaf rules above; the relative-position
tables and the DeiT ``pos_embed`` keep their names and layout (the JAX DeiT
has no cls token). A ``transp_conv`` kernel (flax ``ConvTranspose``, which
does not turn its kernel) becomes the ``ConvTranspose2d`` weight
(in, out, kh, kw) with both spatial axes flipped.

The classifiers MPViT and CoaT (a tree whose top holds ``stage0_invres`` or
``cls_token1``) keep the flax module names too; inside them a CRPE's
``w3/w5/w7``, ``b3/b5/b7`` become ``conv_list.{0,1,2}`` and an MPViT path's
``block{i}`` becomes ``mhca_blks.{i}``, and CoaT's ``cls_token{i}``,
``agg_weight`` and ``agg_bias`` keep their names and layout.

Any key it does not map raises ``KeyError``. Given the port's ``model``,
the result is held to it: each leaf maps to exactly one of its tensors, of
the same shape, and every parameter and buffer is set, or ``ValueError``
names what drifted.
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


# the top-level flax modules of the comparators' trees
_ZOO_TOPS = ("patch_embed", "inc0", "transformer", "resnet")
# a comparator's leaves besides _LEAF's, kept as they are
_ZOO_LEAVES = ("relative_position_bias_table", "pos_embed", "absolute_pos_embed")


# the top-level flax modules that mark a classifier's tree (MPViT, CoaT), the
# leaves it keeps as they are, and the rewrites inside its paths
_CLASSIFIER_TOPS = ("stage0_invres", "cls_token1")
_CLASSIFIER_LEAVES = re.compile(r"cls_token\d|agg_weight|agg_bias")
_CLASSIFIER_RULES = [
    *((rf"(^|/)(crpe\d*)/{p}{k}$", rf"\1\2/conv_list/{i}/{leaf}")
      for i, k in enumerate((3, 5, 7)) for p, leaf in (("w", "kernel"), ("b", "bias"))),
    (r"/block(\d+)/", r"/mhca_blks/\1/"),
]


def _tops(flat: Mapping[str, np.ndarray]) -> set[str]:
    return {k.partition("/")[2].split("/")[0] for k in flat}


def _zoo_leaf(path: str, arr: np.ndarray, classifier: bool = False
              ) -> tuple[str, torch.Tensor]:
    """A comparator's (or, ``classifier``, an MPViT's or CoaT's) flax leaf →
    (torch name, tensor)."""
    if classifier:
        for pat, repl in _CLASSIFIER_RULES:
            path = re.sub(pat, repl, path)
    mod, _, leaf = path.rpartition("/")
    if leaf in _ZOO_LEAVES or (classifier and _CLASSIFIER_LEAVES.fullmatch(leaf)):
        return path.replace("/", "."), torch.from_numpy(np.array(arr, np.float32))
    if leaf not in _LEAF:
        raise KeyError(f"no mapping for flax leaf {path!r}")
    if leaf == "kernel" and mod.endswith("transp_conv"):  # (kh, kw, in, out), unturned
        t = np.ascontiguousarray(np.transpose(arr[::-1, ::-1], (2, 3, 0, 1)), np.float32)
        return f"{mod}/weight".replace("/", "."), torch.from_numpy(t)
    t = _to_torch(arr) if leaf == "kernel" else torch.from_numpy(np.array(arr, np.float32))
    return f"{mod}/{_LEAF[leaf]}".replace("/", "."), t


def check_state(state: Mapping[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Raise ``ValueError`` unless ``state`` sets every tensor of
    ``model.state_dict()`` with one of the same shape, and nothing else."""
    want = model.state_dict()
    problems = [f"unset: {k}" for k in want if k not in state]
    problems += [f"no such tensor: {k}" for k in state if k not in want]
    problems += [f"shape {tuple(v.shape)} for {k} {tuple(want[k].shape)}"
                 for k, v in state.items() if k in want and v.shape != want[k].shape]
    if problems:
        raise ValueError("converted variables do not fit the model: "
                         + "; ".join(problems[:20]))


def from_jax_variables(variables: Mapping[str, Any],
                       model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """flax variables of a ported model → the port's ``state_dict`` (fp32
    tensors), held to ``model`` (``check_state``) when it is given."""
    flat = _flatten(variables)
    state: dict[str, torch.Tensor] = {}
    tops = _tops(flat)
    classifier = bool(tops & set(_CLASSIFIER_TOPS))
    if classifier or tops & set(_ZOO_TOPS):
        for key, arr in flat.items():
            collection, _, path = key.partition("/")
            if collection not in ("params", "batch_stats"):
                raise KeyError(f"no mapping for flax collection of {key!r}")
            name, t = _zoo_leaf(path, arr, classifier)
            if name in state:
                raise ValueError(f"two flax leaves map to {name}")
            state[name] = t
        if model is not None:
            check_state(state, model)
        return state
    dsn = _is_dsn(flat)
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
    if model is not None:
        check_state(state, model)
    return state
