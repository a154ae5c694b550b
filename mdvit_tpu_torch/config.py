"""Config system, the port's own copy of ``mdvit_tpu/config.py``: defaults,
YAML file and CLI overrides → ``DotDict`` (CLI > file > defaults).

Differences from the JAX package:

* ``device`` defaults to ``"cuda"``; ``"cpu"`` runs every kernel wrapper's
  plain version (the tests' setting);
* ``save_config`` writes JSON text, which YAML readers accept, and
  ``load_config`` imports ``yaml`` only for a user's file that is not JSON;
* of the ``tpu`` block, ``mesh.data`` (the cap on the data-parallel group),
  ``distributed`` (torchrun's multi-node rendezvous; ``check_supported``
  raises without it), ``compute_dtype``, ``device_augment``, ``device_eval``,
  ``remat`` and ``profile_steps`` act; ``xla_options`` and ``donate`` are
  XLA-only and ignored.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Any

from mdvit_tpu_torch.utils.pieces import DotDict, read_yaml

DEFAULT_CONFIG: dict[str, Any] = {
    "name": "mdvit_tpu_torch experiment",
    "root_dir": ".",
    "device": "cuda",
    "debug": False,  # True: one batch per train/val/test loop, one epoch
    "seed": 42,
    "model": "MDViT",
    "pretrained_folder": "",  # converted TransFuse backbones (convert_torch_weights)
    "data": {
        "name": ["isic2018", "PH2", "DMF", "SKD"],
        "data_folder": "./data/skin_lesion",
        "k_fold": "4",  # 'No' or '0'..'4' (string, as in the reference)
        "split_ratio": [0.8, 0.2],
        "use_val": False,
        "train_aug": True,
        "img_size": 256,
        "synthetic": False,  # generated data (tests, benchmarks)
        "synthetic_sizes": None,  # per-domain (train, test) counts when synthetic
    },
    "train": {
        "num_workers": 2,
        "num_epochs": 200,
        "save_last_every": 5,  # full-state resume checkpoint cadence, epochs
        "num_iters": False,
        "batch_size": 4,  # per-domain batch size
        "optimizer": {
            "mode": "adamw",
            "adamw": {"lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8,
                      "weight_decay": 0.05},
            "adam": {"lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8},
        },
        "scheduler": {"mode": "step", "step_size": 50, "gamma": 0.5},
        "alpha": 0.5,  # MKD loss mixing weight
        "det_sup": True,  # aux losses do not update domain_layer params
    },
    "test": {"only_test": False, "test_model_dir": "", "num_workers": 2,
             "batch_size": 5},
    "model_encoder_id": 0,
    "model_adapt": {"adapt_method": "Sup", "Sup_label": "Domain",
                    "use_one_hot": True, "num_domains": 4},
    "kt": {"ensemble_method": "att"},
    "tpu": {
        "mesh": {"data": -1},  # cap on the data-parallel ranks; -1 and 0: all
        "compute_dtype": "bfloat16",  # 'bfloat16' | 'float32'
        "device_augment": True,  # augmentation inside the train step, on the card
        "device_eval": True,  # eval splits resident on the card; index rows only
        "donate": True,  # XLA-only, ignored
        "remat": False,  # recompute the forward's activations in the backward
        "xla_options": {"xla_tpu_scoped_vmem_limit_kib": "24576"},  # XLA-only, ignored
    },
    "log": {"every_steps": 10, "backend": "csv"},
}

_NUMERIC_KEYS = {"lr", "eps", "weight_decay", "gamma", "alpha"}


def _normalize_numerics(obj: Any) -> Any:
    """String-typed numerics (the reference stores lr: '1e-4') → float."""
    if isinstance(obj, dict):
        return {k: float(v) if k in _NUMERIC_KEYS and isinstance(v, str)
                else _normalize_numerics(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalize_numerics(v) for v in obj]
    return obj


def _deep_update(base: dict, upd: dict) -> dict:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(config_yml: str | None = None,
                overrides: dict[str, Any] | None = None) -> DotDict:
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if config_yml:
        _deep_update(cfg, _normalize_numerics(read_yaml(config_yml) or {}))
    if overrides:
        _deep_update(cfg, _normalize_numerics(overrides))
    return DotDict(cfg)


def check_supported(cfg: DotDict) -> None:
    """Raise on ``tpu`` settings this process cannot honour:
    ``tpu.distributed`` joins the process group that torchrun's environment
    describes (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ...), so it needs
    that environment."""
    if (cfg.get("tpu") or {}).get("distributed") and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "tpu.distributed: no torchrun environment (WORLD_SIZE); launch with "
            "torchrun --nnodes=... --nproc_per_node=... -m mdvit_tpu_torch.cli")


def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's surface (``mdvit_tpu/config.py:build_argparser``)."""
    p = argparse.ArgumentParser(description="mdvit_tpu_torch training")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--config_yml", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--adapt_method", type=str, default=None)
    p.add_argument("--sup_label", type=str, default=None)
    p.add_argument("--dataset", type=str, nargs="+", default=None)
    p.add_argument("--k_fold", type=str, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--data_folder", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--exp_dir", type=str, default=None,
                   help="exact experiment dir (overrides the timestamped path; "
                   "point at an existing run to resume from its last checkpoint)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="write a torch.profiler trace of this many train steps "
                   "to <exp_dir>/profile")
    p.add_argument("--distributed", action="store_true",
                   help="multi-node data parallelism: join torchrun's rendezvous")
    return p


def config_from_args(args: argparse.Namespace) -> DotDict:
    overrides: dict[str, Any] = {}
    if args.model is not None:
        overrides["model"] = args.model
    if args.batch_size is not None:
        overrides.setdefault("train", {})["batch_size"] = args.batch_size
    if args.num_epochs is not None:
        overrides.setdefault("train", {})["num_epochs"] = args.num_epochs
    if args.adapt_method is not None:
        m = args.adapt_method
        overrides.setdefault("model_adapt", {})["adapt_method"] = (
            False if m in ("False", "false", "none", "None") else m)
    if args.sup_label is not None:
        overrides.setdefault("model_adapt", {})["Sup_label"] = args.sup_label
    if args.dataset is not None:
        overrides.setdefault("data", {})["name"] = list(args.dataset)
    if args.k_fold is not None:
        overrides.setdefault("data", {})["k_fold"] = args.k_fold
    if args.data_folder is not None:
        overrides.setdefault("data", {})["data_folder"] = args.data_folder
    if args.synthetic:
        overrides.setdefault("data", {})["synthetic"] = True
    if args.debug:
        overrides["debug"] = True
    if args.profile_steps:
        overrides.setdefault("tpu", {})["profile_steps"] = args.profile_steps
    if args.distributed:
        overrides.setdefault("tpu", {})["distributed"] = True
    cfg = load_config(args.config_yml, overrides)
    cfg["exp_name"] = args.exp_name
    cfg["results_dir"] = args.results_dir
    return cfg


def save_config(cfg: DotDict, path: str) -> None:
    """JSON text (a YAML reader takes it too)."""
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
        f.write("\n")
