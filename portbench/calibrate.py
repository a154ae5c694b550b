"""Readings that the limits of a cell's check are set from, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... [--control K]

For every seed, the system's numbers as a run's check computes them (set-up
and, for serving, a short window at the cell's load; then the reference).
For the first ``K`` seeds, the control: the plain reference in TF32, the
precision below the configuration's (fp32 with TF32 off), put in the
system's place; and for a train cell the planted fault "half of each
domain's rows left out, the losses their mean over the rest", in the
reference put in the system's place. (A state left unchanged reads 1 on the
update, and a gradient the optimizer never took reads 1 on the gradient:
they need no run.) One JSON line a seed. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch


def readings(cell: str, seeds: list[int], control: int, device, cfg: dict | None = None,
             mix: dict | None = None) -> list[dict]:
    """The readings of ``cell`` (its configuration and mix, or ``cfg`` and
    ``mix`` in their place) on ``device``."""
    from portbench import run, trace
    from portbench.traffic import train

    _, _, cell_cfg, cell_mix = run.cell_spec(cell)
    cfg, mix = cfg or cell_cfg, mix or cell_mix
    module = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    out = []
    for i, seed in enumerate(seeds):
        t = module.Traffic(cfg, mix, seed, device, trace.Spans(False))
        t.setup()
        if mix["kind"] == "serve":
            t.window(steps=2 * mix["pool"])
        t.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = t.reference()
        rec = {"seed": seed, "program": t.check(ref)}
        if i < control:
            if mix["kind"] == "train":
                rec["control"] = train.compare(t.reference(tf32=True), ref,
                                               mix["excluded_below"])
                rec["fault_half"] = train.compare(t.reference(keep=mix["per_domain_batch"] // 2),
                                                  ref, mix["excluded_below"])
            else:
                tf32 = t.reference(tf32=True)
                rec["control"] = {"prob": max(float((a - b).abs().max())
                                              for a, b in zip(tf32, ref))}
        out.append(rec)
        print(json.dumps(rec), flush=True)
        del t, ref
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    import mdvit_tpu_torch  # noqa: F401  (sets cuBLAS's workspace before any handle)

    readings(args.workload, args.seeds, args.control, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
