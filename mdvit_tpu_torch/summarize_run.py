"""Summarize a training run's ``scalars.jsonl`` into a compact evidence JSON,
the port's copy of ``scripts/summarize_run.py``: per epoch the average val
Dice and IoU and the logged lr, the best epoch and every lr transition. The
port's trainer logs the same tags (``Val/Average/IOU``,
``Val/Average/Di_score``, ``Train/lr``).

Usage::

    python -m mdvit_tpu_torch.summarize_run <exp_dir> [--epochs e1,e2,...] \\
        [--out summary.json]
"""
from __future__ import annotations

import argparse
import json
import os


def load(exp_dir: str) -> dict:
    val_iou, val_dice, lr = {}, {}, {}
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            t = r["tag"]
            if t == "Val/Average/IOU":
                val_iou[r["step"]] = r["value"]
            elif t == "Val/Average/Di_score":
                val_dice[r["step"]] = r["value"]
            elif t == "Train/lr":
                lr[r["step"]] = r["value"]
    return {"val_iou": val_iou, "val_dice": val_dice, "lr": lr}


def summarize(exp_dir: str, epochs: str = "") -> dict:
    """The summary of ``exp_dir``; ``epochs``: comma-separated epochs to
    include besides the first, the last and each lr transition."""
    s = load(exp_dir)
    run = sorted(s["val_iou"])
    transitions = []
    prev = None
    for e in sorted(s["lr"]):
        if prev is not None and s["lr"][e] != prev:
            transitions.append({"epoch": e, "lr": s["lr"][e]})
        prev = s["lr"][e]
    best = max(run, key=lambda e: s["val_iou"][e]) if run else None
    pick = sorted({
        *(int(x) for x in epochs.split(",") if x),
        *(e for e in (0, run[-1] if run else 0) if e in s["val_iou"]),
        *(t["epoch"] for t in transitions),
    })
    return {
        "exp_dir": exp_dir,
        "epochs_run": len(run),
        "best_epoch": best,
        "best_val_iou": s["val_iou"].get(best),
        "lr_transitions": transitions,
        "epochs": [
            {"epoch": e, "val_dice": round(s["val_dice"].get(e, 0.0), 6),
             "val_iou": round(s["val_iou"].get(e, 0.0), 6),
             "lr": s["lr"].get(e)}
            for e in pick if e in s["val_iou"]
        ],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="summarize a run's scalars.jsonl")
    ap.add_argument("exp_dir")
    ap.add_argument("--epochs", default="",
                    help="comma-separated epochs to include explicitly")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    text = json.dumps(summarize(args.exp_dir, args.epochs), indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
