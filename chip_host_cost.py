#!/usr/bin/env python3
"""Host cost of the port's kernel calls, one tree against another, on one
NVIDIA card.

Run from the root of a checkout, with a second tree (for example a ``git
archive`` of the parent commit unpacked under ``build/parent``)::

    python3 chip_host_cost.py --parent build/parent [--rounds 2]

It measures each tree in its own process, in the order parent, this, this,
parent (``--rounds`` such pairs of pairs), so a drift of the host's speed
falls on both alike. Each process imports its tree's ``mdvit_tpu_torch``,
builds its kernels and prints one JSON line:

* ``eager_ms``: CUDA events around 20 eager calls (after 3), under
  ``no_grad``, of each kernel's route at the four MDViT stage shapes, B=16,
  fp32 and bf16, as ``chip_smoke.py`` phases 2 and 3 time it: the public
  ``factorized_attention``, ``cpe_conv`` and ``crpe_conv`` and the backward
  route (the ops ``torch.ops.mdvit.*_bwd`` where the tree registers them,
  else the wrappers ``_backward``, ``_cpe_backward``, ``_crpe_backward``);
* ``train_eager_ms``: the same for the forwards with inputs that need a
  gradient (the autograd node is made, the backward not run);
* ``serving_b1``: the fp32 serving forward (``predict.make_forward``) of
  the full-width MDViT at 256², B=1, random weights from seed 0: host clock
  around each call ended by a synchronize, 50 calls after 5.

Then it prints, per kernel, shape and dtype, the mean of each tree's runs
and the change's difference in µs, the card's name and power limit, and
the serving latencies. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

STAGES = [(64, 64, 64, 8), (32, 32, 128, 16), (16, 16, 320, 40), (8, 8, 512, 64)]
BATCH, IMG = 16, 256
KINDS = ("factorized_attention", "cpe_conv", "crpe_conv",
         "factorized_attention_bwd", "cpe_conv_bwd", "crpe_conv_bwd")


def measure(tree: str) -> dict:
    """One tree's numbers; ``tree``'s package shadows any other."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    from mdvit_tpu_torch.device import no_tf32
    from mdvit_tpu_torch.models.registry import build_mdvit
    from mdvit_tpu_torch.ops import dwconv, kernels
    from mdvit_tpu_torch.ops import factorized_attention as fa
    from mdvit_tpu_torch.predict import make_forward

    assert os.path.abspath(fa.__file__).startswith(os.path.abspath(tree)), fa.__file__
    kernels.build()
    ops = not hasattr(fa, "_FactorizedAttention")

    def eager_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def backward(kind):
        if ops:
            return getattr(torch.ops.mdvit, kind)
        return {"factorized_attention_bwd": fa._backward,
                "cpe_conv_bwd": dwconv._cpe_backward,
                "crpe_conv_bwd": dwconv._crpe_backward}[kind]

    gen = torch.Generator().manual_seed(0)

    def inputs(kind, h, w, c, ch, dtype, grad=False):
        """A call's arguments at one stage shape: q, k, v (CRPE's q, v)
        slices of one projection, as the model gives them."""
        def t(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

        base, bwd = kind.removesuffix("_bwd"), kind.endswith("_bwd")
        g = [t(BATCH, h * w, c) if base == "factorized_attention" else t(BATCH, h, w, c)]
        if base == "factorized_attention":
            qkv = t(BATCH, h * w, 3 * c).requires_grad_(grad)
            args = [qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]]
            return args + (g if bwd else []) + [ch, ch ** -0.5]
        if base == "cpe_conv":
            return [t(BATCH, h, w, c).requires_grad_(grad), t(3, 3, c, std=0.5)] + (
                g if bwd else [t(c, std=0.1)])
        qkv = t(BATCH, h, w, 3 * c).requires_grad_(grad)
        return [qkv[..., :c], qkv[..., 2 * c:], t(7, 7, c, std=0.2), t(c, std=0.1)] + (
            g if bwd else [])

    public = {"factorized_attention": fa.factorized_attention, "cpe_conv": dwconv.cpe_conv,
              "crpe_conv": dwconv.crpe_conv}
    rec = {"tree": tree, "ops": ops, "eager_ms": {}, "train_eager_ms": {}}
    with no_tf32():
        for kind, (h, w, c, ch), dtype in itertools.product(
                KINDS, STAGES, (torch.float32, torch.bfloat16)):
            key = f"{kind} {h}x{w}x{c} {str(dtype).replace('torch.', '')}"
            fn = backward(kind) if kind.endswith("_bwd") else public[kind]
            args = inputs(kind, h, w, c, ch, dtype)
            with torch.no_grad():
                rec["eager_ms"][key] = eager_ms(lambda: fn(*args))
            if kind in public:
                args = inputs(kind, h, w, c, ch, dtype, grad=True)
                rec["train_eager_ms"][key] = eager_ms(lambda: fn(*args))

        model = build_mdvit(img_size=IMG, num_domains=4, dtype=torch.float32,
                            device="cuda", seed=0)
        forward = make_forward(model)
        images = torch.randint(0, 256, (1, IMG, IMG, 3), generator=gen).float().cuda()
        onehot = torch.eye(4, device="cuda")[:1]
        for _ in range(5):
            forward(images, onehot)
        torch.cuda.synchronize()
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            forward(images, onehot)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    rec["serving_b1"] = {"latency_ms_mean": sum(lat) / len(lat), "latency_ms_p50": lat[25],
                         "latency_ms_min": lat[0]}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("chip_host_cost: needs a CUDA device and --parent", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    runs: dict[str, list] = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure",
                                   trees[name]], capture_output=True, text=True,
                                  cwd=trees[name], timeout=900)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[name].append(rec)
            print(json.dumps({"run": name, **rec}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    summary = {}
    for field in ("eager_ms", "train_eager_ms"):
        for key in runs["change"][0][field]:
            p = [r[field][key] for r in runs["parent"]]
            c = [r[field][key] for r in runs["change"]]
            mp, mc = sum(p) / len(p), sum(c) / len(c)
            summary[f"{field} {key}"] = {"parent_ms": mp, "change_ms": mc,
                                         "delta_us": (mc - mp) * 1e3,
                                         "parent_runs": p, "change_runs": c}
    serving = {name: [r["serving_b1"] for r in rs] for name, rs in runs.items()}
    print(json.dumps({"summary": summary, "serving_b1": serving, "device": smi}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
