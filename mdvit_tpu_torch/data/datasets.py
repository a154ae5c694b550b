"""Datasets, the port's own copy of ``mdvit_tpu/data/datasets.py``: the
npy/csv layout, the seeded splits, k-fold and the synthetic generator.

``<data_folder>/<dataset>/meta_<dataset>.csv`` (columns incl. ID) plus
``Image/<ID>.npy`` and ``Label/<ID>.npy``. Split files
``{train,test}_meta_kfold_{k}.csv`` (or ``train_meta_80.csv`` …) come from the
reference's ``random.Random(42).shuffle`` recipe, so folds match it. CSVs go
through the standard ``csv`` module; rows are dicts of strings.

Each split is loaded once, resized to the training resolution (bilinear
image, nearest mask) and handed to the loader as a dense uint8 array that
lives on the card; augmentation runs there (``data/augment.py``). The
synthetic generator draws from ``np.random.RandomState`` in the JAX
package's order, so it gives the same bytes.
"""
from __future__ import annotations

import csv
import os
import random
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from mdvit_tpu_torch.data.preprocess import resize_bilinear_np

dataset_indices = {"isic2018": 0, "PH2": 1, "DMF": 2, "SKD": 3}

# train-split sizes in the default 4-domain recipe (multi_train_MDViT.py:470)
REFERENCE_DOMAIN_SIZES = {"isic2018": 2594, "PH2": 200, "DMF": 1212, "SKD": 206}


def resize_nearest_np(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.INTER_NEAREST resize: source index = floor(dst · scale)."""
    h, w = img.shape[0], img.shape[1]
    if h == size and w == size:
        return img
    ys = np.minimum((np.arange(size) * (h / size)).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(size) * (w / size)).astype(np.int64), w - 1)
    return img[ys][:, xs]


@dataclass
class DomainArrays:
    """One split of one domain as dense host arrays (the loader moves them
    to the card)."""

    name: str
    domain_id: int
    images: np.ndarray  # (N, S, S, 3) uint8
    masks: np.ndarray  # (N, S, S) uint8 {0,1}
    ids: list = field(default_factory=list)

    def __len__(self) -> int:
        return self.images.shape[0]


def read_csv_rows(path: str) -> tuple[list[str], list[dict[str, str]]]:
    """(header, rows) of a CSV file, every value a string."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames or []), list(reader)


def write_csv_rows(path: str, header: Sequence[str], rows: Sequence[dict]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(header), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def write_kfold_splits(data_path: str, dataset_name: str) -> None:
    """The 5 seeded fold CSVs, as the reference writes them
    (``create_dataset.py:57-70``)."""
    header, rows = read_csv_rows(os.path.join(data_path, f"meta_{dataset_name}.csv"))
    n = len(rows)
    index_list = list(range(n))
    random.Random(42).shuffle(index_list)
    split_size = int(n / 5.0 + 0.5)
    split_ids = [0, split_size, split_size * 2, split_size * 3, split_size * 4, n]
    for i in range(5):
        train = index_list[: split_ids[i]] + index_list[split_ids[i + 1]:]
        test = index_list[split_ids[i]: split_ids[i + 1]]
        write_csv_rows(os.path.join(data_path, f"train_meta_kfold_{i}.csv"), header,
                       [rows[j] for j in train])
        write_csv_rows(os.path.join(data_path, f"test_meta_kfold_{i}.csv"), header,
                       [rows[j] for j in test])


def write_ratio_splits(data_path: str, dataset_name: str, split_ratio=(0.8, 0.2)) -> None:
    """80/20 split CSVs (``create_dataset.py:96-111``)."""
    header, rows = read_csv_rows(os.path.join(data_path, f"meta_{dataset_name}.csv"))
    n = len(rows)
    index_list = list(range(n))
    random.Random(42).shuffle(index_list)
    cut = int(n * split_ratio[0])
    write_csv_rows(os.path.join(data_path, f"train_meta_{int(split_ratio[0] * 100)}.csv"),
                   header, [rows[j] for j in index_list[:cut]])
    write_csv_rows(os.path.join(data_path, f"test_meta_{int(split_ratio[1] * 100)}.csv"),
                   header, [rows[j] for j in index_list[cut:]])


def load_split_rows(data_path: str, dataset_name: str, k_fold: str, split_ratio,
                    split: str) -> list[dict[str, str]]:
    """The rows of one split's CSV, writing the split files first if missing
    (``_load_split_df`` of the JAX package)."""
    if k_fold != "No":
        path = os.path.join(data_path, f"{split}_meta_kfold_{k_fold}.csv")
        if not os.path.exists(path):
            write_kfold_splits(data_path, dataset_name)
        return read_csv_rows(path)[1]
    pct = int(split_ratio[0] * 100) if split == "train" else int(split_ratio[1] * 100)
    path = os.path.join(data_path, f"{split}_meta_{pct}.csv")
    if not os.path.exists(path):
        write_ratio_splits(data_path, dataset_name, split_ratio)
    return read_csv_rows(path)[1]


def load_domain_arrays(data_folder: str, dataset_name: str, img_size: int,
                       k_fold: str = "4", split_ratio=(0.8, 0.2)) -> dict[str, DomainArrays]:
    """Train and test splits of one domain as dense uint8 arrays at
    ``img_size`` (resized once, at load)."""
    from mdvit_tpu_torch.data.native_loader import batch_load_u8

    data_path = os.path.join(data_folder, dataset_name)
    out = {}
    for split in ("train", "test"):
        ids = [str(row["ID"]) for row in load_split_rows(
            data_path, dataset_name, k_fold, split_ratio, split)]
        n = len(ids)
        images = np.empty((n, img_size, img_size, 3), np.uint8)
        masks = np.empty((n, img_size, img_size), np.uint8)
        img_paths = [os.path.join(data_path, "Image", f"{s}.npy") for s in ids]
        lbl_paths = [os.path.join(data_path, "Label", f"{s}.npy") for s in ids]

        # whole-split load through the threaded C++ reader when the corpus is
        # uniform uint8 (a mismatch gives None and the per-file numpy load)
        raw_imgs = raw_lbls = None
        if n > 0:
            probe = np.load(img_paths[0])
            if probe.dtype == np.uint8:
                raw_imgs = batch_load_u8(img_paths, probe.shape)
                probe_l = np.load(lbl_paths[0])
                if probe_l.dtype == np.uint8:
                    raw_lbls = batch_load_u8(lbl_paths, probe_l.shape)

        for i in range(n):
            img = raw_imgs[i] if raw_imgs is not None else np.load(img_paths[i])
            lbl = raw_lbls[i] if raw_lbls is not None else np.load(lbl_paths[i])
            lbl = (lbl > 0.5).astype(np.uint8)
            images[i] = np.clip(resize_bilinear_np(img.astype(np.float32), img_size),
                                0, 255).astype(np.uint8)
            masks[i] = resize_nearest_np(lbl, img_size)
        out[split] = DomainArrays(name=dataset_name,
                                  domain_id=dataset_indices.get(dataset_name, 0),
                                  images=images, masks=masks, ids=ids)
    return out


def synthetic_domain_arrays(dataset_name: str, img_size: int, n_train: int, n_test: int,
                            seed: int | None = None) -> dict[str, DomainArrays]:
    """Deterministic synthetic lesion-like data (ellipse blobs on noise) for
    tests and benchmarks where the npy corpus is absent."""
    domain_id = dataset_indices.get(dataset_name, 0)
    rng = np.random.RandomState(seed if seed is not None else 1000 + domain_id)
    out = {}
    for split, n in (("train", n_train), ("test", n_test)):
        images = np.empty((n, img_size, img_size, 3), np.uint8)
        masks = np.empty((n, img_size, img_size), np.uint8)
        yy, xx = np.mgrid[0:img_size, 0:img_size]
        for i in range(n):
            cy, cx = rng.uniform(0.3, 0.7, 2) * img_size
            ry, rx = rng.uniform(0.1, 0.3, 2) * img_size
            theta = rng.uniform(0, np.pi)
            ys, xs = yy - cy, xx - cx
            yr = ys * np.cos(theta) - xs * np.sin(theta)
            xr = ys * np.sin(theta) + xs * np.cos(theta)
            mask = ((yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0).astype(np.uint8)
            base = rng.uniform(120, 200)
            img = rng.normal(base, 15, (img_size, img_size, 3))
            lesion = rng.uniform(40, 110, 3)
            img = np.where(mask[..., None] > 0, lesion + 10 * rng.randn(), img)
            images[i] = np.clip(img, 0, 255).astype(np.uint8)
            masks[i] = mask
        out[split] = DomainArrays(
            name=dataset_name, domain_id=domain_id, images=images, masks=masks,
            ids=[f"{dataset_name}_{split}_{i}" for i in range(n)])
    return out


def build_domain_data(names: Sequence[str], data_folder: str, img_size: int,
                      k_fold: str = "4", split_ratio=(0.8, 0.2), synthetic: bool = False,
                      synthetic_sizes: dict | None = None) -> dict[str, dict[str, DomainArrays]]:
    """{dataset_name: {'train': DomainArrays, 'test': DomainArrays}}"""
    result = {}
    for name in names:
        if synthetic:
            sizes = (synthetic_sizes or {}).get(name, (24, 8))
            result[name] = synthetic_domain_arrays(name, img_size, sizes[0], sizes[1])
        else:
            result[name] = load_domain_arrays(data_folder, name, img_size, k_fold,
                                              split_ratio)
    return result
