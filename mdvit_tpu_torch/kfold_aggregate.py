"""K-fold result aggregator, the port's copy of ``scripts/kfold_aggregate.py``
(the reference's ``Evaluation/k_fold_val.ipynb``, cells 2-5) in ``csv`` and
numpy, without pandas: each fold's ``test_results.csv`` is read, its rows
keyed by the first column (``Name``) and checked against fold 0's, and a fold
whose rows do not match is refused; then the mean and the population std
(``np.std``, ddof=0, as the notebook) over folds of every other column, as
``k_fold.csv`` with the notebook's ``<col>_m`` / ``<col>_s`` schema.

Usage::

    python -m mdvit_tpu_torch.kfold_aggregate --exp_dirs results/run_fold0 ... \\
        --out k_fold.csv
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def _read(exp_dir: str) -> tuple[list[str], list[list[str]]]:
    with open(os.path.join(exp_dir, "test_results.csv"), newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def aggregate(exp_dirs: list[str]) -> dict[str, list]:
    """The ``k_fold.csv`` columns, in order: the name column, then
    ``<col>_m`` and ``<col>_s`` for each column of fold 0's csv."""
    head, rows = _read(exp_dirs[0])
    names = [r[0] for r in rows]
    folds = [[[float(v) for v in r[1:]] for r in rows]]
    for d in exp_dirs[1:]:
        fhead, frows = _read(d)
        keyed = {r[0]: dict(zip(fhead[1:], r[1:])) for r in frows}
        missing = [n for n in names if n not in keyed]
        extra = [n for n in keyed if n not in names]
        if missing or extra:
            raise SystemExit(f"{d}/test_results.csv rows do not match fold 0"
                             f" (missing {missing}, extra {extra})")
        folds.append([[float(keyed[n][col]) for col in head[1:]] for n in names])
    vals = np.asarray(folds, dtype=np.float64)  # (folds, rows, cols)
    avg, std = vals.mean(axis=0), vals.std(axis=0)
    out: dict[str, list] = {head[0]: names}
    for j, col in enumerate(head[1:]):
        out[f"{col}_m"] = [float(v) for v in avg[:, j]]
        out[f"{col}_s"] = [float(v) for v in std[:, j]]
    return out


def write_csv(columns: dict[str, list], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(columns))
        w.writerows(zip(*columns.values()))


def format_table(columns: dict[str, list]) -> str:
    cells = [list(columns)] + [[v if isinstance(v, str) else f"{v:.6f}" for v in row]
                               for row in zip(*columns.values())]
    widths = [max(len(r[j]) for r in cells) for j in range(len(cells[0]))]
    return "\n".join(" ".join(c.rjust(n) for c, n in zip(r, widths)) for r in cells)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="mean and std of k folds' test_results.csv")
    p.add_argument("--exp_dirs", nargs="+", required=True)
    p.add_argument("--out", default="k_fold.csv")
    args = p.parse_args(argv)
    columns = aggregate(args.exp_dirs)
    write_csv(columns, args.out)
    print(format_table(columns))


if __name__ == "__main__":
    main()
