"""Export a trained model's serving forward with ``torch.export``.

Counterpart of ``scripts/export_model.py``: the artifact is the program of
``predict.Serving`` (the eval preprocessing, the primary head and the
sigmoid), ``(images 0..255 (B, S, S, 3) f32, domain onehot (B, D) f32) →
probability maps (B, S, S)`` at a fixed batch, with the weights inside,
written by ``torch.export.save``. It holds no TF32 flag: the export and the
check run with TF32 off (``device.no_tf32``), and so should its caller.

Usage::

    python -m mdvit_tpu_torch.export --ckpt_dir EXP --out model.pt2 \\
        [--batch_size 8] [--device cuda] [--check]

``EXP`` is an experiment dir of the port's trainer (``best.pt`` and
``exp_config.yml``). ``--check`` reloads the file and runs it against the
live forward on random inputs: on the card both run the same kernels and
must agree bit for bit; on the CPU both run the same plain versions, within
1e-6.

The program calls the kernels as the custom ops ``torch.ops.mdvit.*``, so
the port's ops modules must be imported (which registers the ops) before it
loads; where JAX's artifact needs only ``jax``, this one needs
``mdvit_tpu_torch``::

    from mdvit_tpu_torch.export import load, run
    program = load("model.pt2")      # torch.export.load(...).module()
    probs = run(program, images, onehot)   # no autograd, TF32 off
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import mdvit_tpu_torch.ops.dwconv  # noqa: F401  registers torch.ops.mdvit.*
import mdvit_tpu_torch.ops.factorized_attention  # noqa: F401
from mdvit_tpu_torch.device import no_tf32
from mdvit_tpu_torch.predict import Serving, load_experiment, make_forward

CPU_TOL = 1e-6


def export_serving(model: torch.nn.Module, batch_size: int, img_size: int,
                   num_domains: int) -> torch.export.ExportedProgram:
    """``Serving(model)`` exported at ``batch_size`` on the model's device."""
    device = next(model.parameters()).device
    x = torch.zeros((batch_size, img_size, img_size, 3), device=device)
    onehot = torch.zeros((batch_size, num_domains), device=device)
    with no_tf32():
        return torch.export.export(Serving(model).eval(), (x, onehot))


def load(path: str) -> torch.nn.Module:
    """The program of an exported file, as a module to call (the import of
    this module has registered the ops it calls)."""
    return torch.export.load(path).module()


def run(program: torch.nn.Module, x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """One call of a loaded program, without autograd and with TF32 off."""
    with torch.no_grad(), no_tf32():
        return program(x, onehot)


def check(path: str, model: torch.nn.Module, batch_size: int, img_size: int,
          num_domains: int, seed: int = 0) -> float:
    """Max |loaded − live| on random 0..255 images of domain 0; raises unless
    bit-equal on the card, within ``CPU_TOL`` on the CPU."""
    device = next(model.parameters()).device
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randint(0, 256, (batch_size, img_size, img_size, 3))
                         .astype(np.float32)).to(device)
    onehot = torch.zeros((batch_size, num_domains), device=device)
    onehot[:, 0] = 1.0
    want = make_forward(model)(x, onehot)
    got = run(load(path), x, onehot)
    err = (got - want).abs().max().item()
    ok = torch.equal(got, want) if device.type == "cuda" else err <= CPU_TOL
    if not ok:
        raise RuntimeError(f"the exported program differs from the live forward: "
                           f"max abs {err} on {device.type}")
    return err


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="mdvit_tpu_torch serving export")
    ap.add_argument("--ckpt_dir", required=True,
                    help="trainer experiment dir (best.pt + exp_config.yml)")
    ap.add_argument("--config_yml", default=None,
                    help="config override (default: the dir's exp_config.yml)")
    ap.add_argument("--out", default="model.pt2")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", action="store_true",
                    help="reload the file and compare it with the live forward")
    args = ap.parse_args(argv)

    model = load_experiment(args.ckpt_dir, args.device, config_yml=args.config_yml)
    img_size, num_domains = model.config["img_size"], model.config["num_domains"]
    bs = max(1, args.batch_size)
    t0 = time.perf_counter()
    program = export_serving(model, bs, img_size, num_domains)
    torch.export.save(program, args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB in "
          f"{time.perf_counter() - t0:.1f} s, in_shapes="
          f"{[(bs, img_size, img_size, 3), (bs, num_domains)]}, device={args.device}")
    if args.check:
        err = check(args.out, model, bs, img_size, num_domains)
        print(f"check ok: the loaded program matches the live forward (max abs {err})")


if __name__ == "__main__":
    main()
