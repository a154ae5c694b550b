"""Readings that the limits of a ``cp_train`` cell's check are set from:

    python3 -m portbench.calibrate_cp --workload <cell> --seeds <n> ... [--faults K]

One spawn of the cell's ranks. For every seed, each rank runs the system's
set-up and compared steps as a run's does (``traffic.cp_train.Rank``); then,
with the system freed, the ranks share the plain references out, one card
each: for every seed the reference of its compared steps, and for the first
``K`` seeds the control (the reference in TF32, the precision below the
configuration's fp32 with TF32 off) and the two planted faults, "half of
each domain's rows left out" and "rows alone" (each rank's block of rows of
every image run as an image of its own: no halo, no gather, attention within
the block), each put in the system's place. Every rank holds the same record
of the system's steps (its parameters are rank 0's: ``ranks_apart``), so a
card compares its own. One JSON line a seed, in seed order; the benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch
import torch.multiprocessing as mp

FAULTS = ("half", "rows_alone")


def plan(seeds: list[int], faults: int, ranks: int) -> list[list[tuple[int, int]]]:
    """Each rank's (index, seed) to reference: a seed with the control and
    faults costs four references, one without them one; the first ``faults``
    seeds go to the first cards, the rest to the least loaded."""
    load, share = [0] * ranks, [[] for _ in range(ranks)]
    for i, seed in enumerate(seeds):
        r = i if i < min(faults, ranks) else min(range(ranks), key=lambda k: (load[k], k))
        share[r].append((i, seed))
        load[r] += 1 + (len(FAULTS) + 1) * (i < faults)
    return share


def rank_main(rank: int, cell: str, seeds: list[int], faults: int, port: int,
              out: str, device: str) -> None:
    from portbench import data, run, trace, weights
    from portbench.traffic import cp_train

    _, _, cfg, mix = run.cell_spec(cell)
    device = cp_train.rank_device(device, rank)
    if device.type != "cuda":
        torch.set_num_threads(1)
    cp_train.join_group(rank, mix, port, device)
    records = {}
    for seed in seeds:
        me = cp_train.Rank(cfg, mix, seed, device, trace.Spans(False))
        records[seed] = me.compared(mix["compared_steps"])
        del me
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    cp_train.end_group()
    lines = []
    for i, seed in plan(seeds, faults, mix["ranks"])[rank]:
        state = weights.from_seed(cfg, seed, device)
        stores = data.stores(seed, cfg["num_domains"], mix["per_domain_store"],
                             cfg["img_size"], device)

        def reference(**kw):
            return cp_train.reference_record(cfg, mix, state, stores, seed, device, **kw)

        ref = reference()
        rec = {"seed": seed, "program": {**cp_train.compare(records[seed], ref,
                                                            mix["excluded_below"]),
                                         "ranks_apart": records[seed]["ranks_apart"]}}
        if i < faults:
            rec["control"] = cp_train.compare(reference(tf32=True), ref, mix["excluded_below"])
            for fault in FAULTS:
                rec[f"fault_{fault}"] = cp_train.compare(reference(fault=fault), ref,
                                                         mix["excluded_below"])
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del state, stores
        if device.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(lines, f)
    if rank:
        cp_train.end_rank()


def _spawned(rank: int, *args) -> None:
    rank_main(rank + 1, *args)


def calibrate(cell: str, seeds: list[int], faults: int, out: str, device: str) -> list:
    """Every seed's readings (``rank_main``'s, on the cell's ranks) and, last,
    the summary: the largest sound reading and the least control and fault
    reading of each number."""
    from portbench import run
    from portbench.traffic import cp_train

    ranks = run.cell_spec(cell)[3]["ranks"]
    os.makedirs(out, exist_ok=True)
    rest = (cell, seeds, faults, cp_train.free_port(), out, device)
    procs = mp.start_processes(_spawned, args=rest, nprocs=ranks - 1, join=False,
                               start_method="spawn")
    rank_main(0, *rest)
    while not procs.join():
        pass
    lines = sorted((rec for r in range(ranks)
                    for rec in json.load(open(os.path.join(out, f"rank{r}.json")))),
                   key=lambda rec: seeds.index(rec["seed"]))
    summary = {}
    for kind in ("program", "control", *(f"fault_{f}" for f in FAULTS)):
        got = [rec[kind] for rec in lines if kind in rec]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(g[k] for g in got) for k in got[0]} if got else None
    return lines + [{"summary": summary}]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="base.train.cp4.r1024")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default="build/portbench/calibrate_cp")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate_cp: no CUDA device", file=sys.stderr)
        return 2
    import mdvit_tpu_torch  # noqa: F401  (sets cuBLAS's workspace before any handle)
    from mdvit_tpu_torch.ops import kernels
    from portbench.reference.train import set_precision

    set_precision(tf32=False)
    kernels.build()
    print(json.dumps(calibrate(args.workload, args.seeds, args.faults, args.out, "cuda")[-1]),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
