"""Pooled encoder features of every sample of each dataset (the counterpart
of ``scripts/extract_features.py``), for t-SNE and the like.

The model's ``feat`` with ``out_seg=False`` (the mean of the last encoder
stage; a comparator's own ``feat``) of each image of a dataset's train split,
read through the eval batches on the device (the eval transform included),
to one ``features_<name>.npz`` a dataset: ``features`` (N, C),
``diagnosis_id`` (N,) from the dataset's ``meta_<name>.csv`` matched by ID
(zeros for a synthetic corpus or without the file), ``domain_id`` (N,) and
``ids``.

Usage::

    python -m mdvit_tpu_torch.extract_features --model MDViT \\
        (--ckpt W.pt | --ckpt EXP | --ckpt EXP/best.pt) \\
        --data_folder ./data/skin_lesion --dataset isic2018 PH2 DMF SKD \\
        --img_size 256 --out features/ [--device cpu]

``W.pt`` is a ``save_weights`` file, ``EXP`` a trainer experiment dir (its
``best.pt``, or the checkpoint file named, rebuilt from its
``exp_config.yml``). Without ``--ckpt`` the weights are drawn from
``--seed``, with the Sup gate, ``--model_kwargs`` (JSON) passing widths.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mdvit_tpu_torch.data.datasets import build_domain_data, dataset_indices, read_csv_rows
from mdvit_tpu_torch.data.loader import EvalSplitStore, eval_index_batches, eval_transform
from mdvit_tpu_torch.device import deterministic, no_tf32, resolve_device


def load_model(ckpt: str | None, name: str, img_size: int, num_domains: int,
               device: torch.device, seed: int = 0, **kw) -> torch.nn.Module:
    """The model of ``ckpt`` (a weight file, an experiment dir or one of its
    checkpoint files), or the registry's ``name`` with weights from ``seed``."""
    from mdvit_tpu_torch.models.registry import build_model, load_weights
    from mdvit_tpu_torch.predict import load_experiment
    from mdvit_tpu_torch.train import checkpoints

    if not ckpt:
        return build_model(name, img_size=img_size, num_domains=num_domains,
                           adapt_method="Sup", device=device, seed=seed, **kw)
    if os.path.isdir(ckpt):
        return load_experiment(ckpt, device)
    blob = torch.load(ckpt, map_location="cpu", weights_only=True)
    if "config" in blob:
        return load_weights(ckpt, device=device)
    model = load_experiment(os.path.dirname(os.path.abspath(ckpt)), device)
    model.load_state_dict(checkpoints.load(ckpt)["model"])
    return model


def diagnosis_ids(data_folder: str, name: str, ids) -> np.ndarray:
    """Each sample's ``diagnosis_id`` from ``<folder>/<name>/meta_<name>.csv``
    by its ID; 0 where there is no row, no column or no file."""
    path = os.path.join(data_folder, name, f"meta_{name}.csv")
    if not os.path.exists(path):
        return np.zeros(len(ids), np.int64)
    header, rows = read_csv_rows(path)
    if "diagnosis_id" not in header:
        return np.zeros(len(ids), np.int64)
    lut = {r["ID"]: int(r["diagnosis_id"]) for r in rows}
    return np.asarray([lut.get(str(s), 0) for s in ids], np.int64)


@torch.no_grad()
@no_tf32()
@deterministic()
def dataset_features(model: torch.nn.Module, store: EvalSplitStore, domain: int,
                     num_domains: int, batch_size: int) -> np.ndarray:
    """(N, C) fp32 features of the store's domain ``domain``, fetched once."""
    device = store.images.device
    onehot = torch.zeros((batch_size, num_domains), device=device)
    onehot[:, domain] = 1.0
    off, n = store.domain(0)
    feats = []
    for idx, valid in eval_index_batches(off, n, batch_size):
        rows = torch.from_numpy(idx.astype(np.int64)).to(device)
        x, _ = eval_transform(store.images[rows].float(), store.masks[rows].float())
        out = model(x, onehot, train=False, out_feat=True, out_seg=False)
        feats.append(out["feat"][:valid].float())
    if not feats:
        return np.zeros((0, 1), np.float32)
    return torch.cat(feats).cpu().numpy()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="mdvit_tpu_torch pooled features")
    p.add_argument("--model", default="MDViT")
    p.add_argument("--ckpt", default=None,
                   help="save_weights file, experiment dir or its checkpoint file; "
                   "random weights from --seed when omitted")
    p.add_argument("--data_folder", default="./data/skin_lesion")
    p.add_argument("--dataset", nargs="+", default=["isic2018", "PH2", "DMF", "SKD"])
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default="./features")
    p.add_argument("--model_kwargs", default=None,
                   help='JSON architecture overrides, e.g. \'{"embed_dims": [8, 8, 8, 8]}\'')
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    extra = {k: tuple(v) if isinstance(v, list) else v
             for k, v in json.loads(args.model_kwargs or "{}").items()}
    num_domains = len(args.dataset)
    model = load_model(args.ckpt, args.model, args.img_size, num_domains, device,
                       args.seed, **extra).eval()
    num_domains = int(model.config["num_domains"])  # a loaded model's one-hot width
    os.makedirs(args.out, exist_ok=True)
    data = build_domain_data(args.dataset, args.data_folder, args.img_size,
                             synthetic=args.synthetic)
    for di, name in enumerate(args.dataset):
        dom = data[name]["train"]
        feats = dataset_features(model, EvalSplitStore([dom], device), di, num_domains,
                                 args.batch_size)
        diag = (np.zeros(len(feats), np.int64) if args.synthetic
                else diagnosis_ids(args.data_folder, name, dom.ids))
        out_path = os.path.join(args.out, f"features_{name}.npz")
        np.savez(out_path, features=feats, diagnosis_id=diag,
                 domain_id=np.full(len(feats), dataset_indices.get(name, di)),
                 ids=np.asarray(dom.ids))
        print(f"{name}: {feats.shape} -> {out_path}")


if __name__ == "__main__":
    main()
