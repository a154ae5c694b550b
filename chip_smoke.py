#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mdvit_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout with no arguments::

    python3 chip_smoke.py [--seed 0]

Phases, each printing JSON lines; any failure exits non-zero:

1. build    compile the CUDA kernels from ``mdvit_tpu_torch/csrc`` (nvcc,
            sm_90a) and print build seconds and ptxas registers/smem/spills;
2. kernels  each forward kernel against its plain PyTorch version at the four
            MDViT stage shapes, B=16, fp32 and bf16, with the tolerances
            below; then device times (CUDA events around a CUDA-graph replay)
            of the kernel, the plain version and (CPE/CRPE)
            ``F.conv2d(groups=C)`` as a library yardstick, beside the bound,
            and the kernel's eager time (host launch cost included); then A
            the same way at B=1 (``kernel_b1`` records, outside the per-step
            sums);
3. backward each backward op (``torch.ops.mdvit.*_bwd``) against its plain
            backward at the same shapes and types, two calls bit-equal,
            and the same times; the
            library yardstick of CPE/CRPE is cuDNN's backward of their
            ``F.conv2d(groups=C)`` forms (``aten.convolution_backward``);
   split    A's device launches per call at B=16 and B=1, and A′'s, B′'s and
            C′'s at B=16 (2 each: A's and A′'s partials and apply kernels;
            B′'s and C′'s fused tile kernel and reduce), and device ms per
            launch by kernel name at each stage shape in fp32 and bf16, from
            ``torch.profiler``;
4. model    the serving entry (``predict.make_forward`` on the full-width
            MDViT at 256², random weights from ``--seed``, 4 domains, mixed
            one-hots) with every launch counter read around one B=16 call;
            the logits through the kernels against the same forward through
            the plain versions; then img/s and latency at B=1 and B=16 in
            fp32 and bf16, and a ``torch.profiler`` window of the same calls
            for device-busy time, idle share, device ops per forward and A's
            device ms and share; peak memory after the cuBLAS workspaces
            that earlier phases left are freed;
5. augment  the on-device augmentation (``data.augment.augment_batch``) at
            D·B = 16, 256²: its device ms and device ops per step, the
            noise's and the hash's share of them, and its wall ms; then
            ``augment_raw`` on the card against the same call on the CPU
            with the same uint8 inputs and parameters: masks equal, images
            (before normalisation) equal but where the noise's floor moved
            by one level, on at most 0.1% of the values;
6. train    the 4-domain MKD train step (``train.steps.make_train_step``) on
            the same model, D=4 × B=4 at 256², synthetic uint8 stores from
            ``--seed``, without augmentation (``device_augment=False``) so
            the comparisons hold one batch: every launch counter read
            around one step; every gradient against the same step through
            the plain versions (and that gap again without dropout, and
            with the heads scaled out of sigmoid saturation); finite fp32
            and bf16 losses; the fp32 loss falling over 10 steps on one
            batch; then the flagship step, with augmentation: img/s, step
            ms, device-busy ms, idle share, device ops per step and peak
            memory in fp32 and bf16, beside the step without augmentation
            (the two timed in alternating pairs; the median extra ms a
            pair) and the augmentation's device ms;
7. trainer  the training CLI's path (``train.trainer.Trainer``): the
            full-width MDViT at 256², D = 4 × B = 4, synthetic data of 32
            train and 10 test images a domain (8 steps an epoch), the
            config's default dtype (bf16), ``fit()`` for 2 epochs with
            ``last`` every epoch, with every launch counter read around it;
            then a second Trainer on the same directory resumes from
            ``last`` (parameters, optimizer and scheduler state, generator
            states and step bit-equal to the first's), trains epoch 2 and
            runs ``test()``; one line with each epoch's img/s, eval seconds,
            the checkpoints' bytes and seconds, the best epoch, the Total
            row of ``test_results.csv``, peak memory and the launches;
8. family   the paper's model family (BASE, BASE+Sup, BASE_DSN, BASE_DASE,
            BASE_USE, MDViT_DSN, MDViT with the MLP, DeepLabV3 and
            Transformer debranches, MDViT without the Sup gate) at full
            width, 256², random weights from ``--seed``, one ``family`` line
            each: the serving forward (``make_forward``, fp32, B=16, mixed
            one-hots) with the launch counters read around it, and its
            logits through the kernels against the plain versions; one
            train step (D=4 × B=4, no augmentation, the name's objective)
            with the counters read around it, its gradients against the
            same step through the plain versions (relative L2), finite fp32
            and bf16 losses; step ms, img/s and device-busy ms in fp32 and
            bf16, serving img/s at B=16 in bf16, and peak memory;
   family_cli  ``Trainer.fit`` of one epoch (bf16, 8 train and 4 test
            images a domain) for BASE_DSN and MDViTᵀ with the counters read
            around it, ``test()``, then ``predict.load_experiment`` and
            ``make_forward`` on each experiment's ``best.pt``;
9. export   ``export.export_serving`` of the full-width MDViT and BASE_DSN
            at B=16 in fp32 and bf16 (random weights from ``--seed``, the
            family phase's BN calibration), saved to a temporary dir,
            loaded and run: the artifact's MB, export and load seconds, the
            loaded program's launches around one call (16 each of A, B, C),
            its bits against the live ``make_forward`` (must be equal), and
            the serving ms of both;
10. remat   one fp32 train step of MDViT and of BASE (dropout 0.1, no
            augmentation) with ``remat`` off and on from one state: the
            counters around each step (MDViT 48 / 31, BASE 32 / 16), equal
            losses, bit-equal BN running stats and generator state, the
            gradients' and the parameter updates' relative L2 within
            ``GRAD_L2_TOL``, and a second plain step (the control) bit-equal
            to the first; step ms, device-busy ms and peak memory of each;
11. kfold_cli two folds of the training CLI (MDViT, full width, one block
            a stage, img 64, bf16, debug), ``kfold_aggregate`` and
            ``summarize_run`` over them, and the export CLI with
            ``--check`` on fold 0's ``best.pt``;
12. determinism  the separable resize against ``F.interpolate``'s forward
            at 64² → 256² (within 1e-6 of the largest value) and what
            ``F.interpolate``'s backward does under
            ``torch.use_deterministic_algorithms``; then for MDViT and BASE
            in fp32 and bf16 two train steps (augmentation on) from one
            state with ``device.deterministic`` on (gradients, updates,
            losses and BN stats must be bit-equal) and off, and each
            setting's step ms and device-busy ms;
13. dp       data parallelism (the flagship step, fp32, augmentation and
            dropout on, SGD): an NCCL group of one against no group
            (bit-equal), then two gloo ranks spawned on the one card, 8 rows
            each, against one process (loss and BN running stats within
            1e-5 relative, gradients and updates within ``GRAD_L2_TOL``,
            replicas bit-equal, 16 / 31 launches a rank) and the step ms of
            each;
14. zoo      the paper's segmentation comparators (UTNet, SwinUnet,
            SwinUNETR, TransFuse_S, TransFuse_S_adapt, TransFuse_L) at full
            width, 256², random weights from ``--seed``, one ``zoo`` line
            each: the serving forward (``make_forward``, fp32, B=16, mixed
            one-hots, after the family's BN calibration) with every launch
            counter read around it (0: none reaches the kernels), its logits
            against the host CPU's at B=2 (within 1e-4·max(1, max|logit|));
            one train step (D=4 × B=4, no augmentation) twice from one state
            in fp32 and bf16 (bit-equal: the control), finite losses, step
            ms, img/s, device-busy ms and peak. Then a ``zoo_more`` line:
            TransFuse_L_384's forward at 384×512 (three maps), one CLI epoch
            of TransFuse_S (bf16) from backbones that
            ``convert_torch_weights`` made of random torchvision/timm
            checkpoints (the graft report, ``test()``), and
            ``extract_features`` of the full-width MDViT on the card against
            the CPU (features within 1e-4 of their scale, ids equal);
15. the ``kernels`` line (launches from the trainer's ``fit``, and by path
   under ``launches_by_path``, ``zoo`` all 0), the card's name and power
   limit, and last the ``{"ok": true, "device": ...}`` line. Each phase
   prints its seconds.

``--dp-cards`` runs only the build and the dp phase, with one NCCL rank on
each visible card (a host of several cards) in place of the gloo ranks.

Every phase runs with TF32 off (``device.no_tf32``), as the entry points
do, so the direct model calls and cuDNN's library times are full fp32 too;
the entry points also run under ``device.deterministic``.
The kernels are reached through their custom ops (``torch.ops.mdvit.*``),
the model's only route to them.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import functools
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from unittest import mock

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mdvit_tpu_torch import cli, export, kfold_aggregate, summarize_run
from mdvit_tpu_torch.config import load_config
from mdvit_tpu_torch.data.augment import augment_batch, augment_raw, sample_aug_params
from mdvit_tpu_torch.data.loader import gather_batch
from mdvit_tpu_torch.data.preprocess import normalize
from mdvit_tpu_torch.device import deterministic, no_tf32
from mdvit_tpu_torch.models.base import split_seg
from mdvit_tpu_torch.models.registry import build_mdvit, build_model
from mdvit_tpu_torch.ops import dwconv, kernels
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import fast_normal, fast_uniform
from mdvit_tpu_torch.ops.resize import resize_bilinear
from mdvit_tpu_torch.predict import load_experiment, make_forward
from mdvit_tpu_torch.train import checkpoints as ckpt
from mdvit_tpu_torch.train import steps as steps_module
from mdvit_tpu_torch.train.optim import build_optimizer
from mdvit_tpu_torch.train.steps import make_train_step
from mdvit_tpu_torch.train.trainer import Trainer

# peak rates of one H100 SXM (NVIDIA data sheet; 700 W): memory bytes/s and
# fp32 FLOP/s outside the tensor cores (all three kernels compute in fp32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# (H, W, C, ch) of the four MDViT stages at 256², 8 heads each
STAGES = [(64, 64, 64, 8), (32, 32, 128, 16), (16, 16, 320, 40), (8, 8, 512, 64)]
BATCH = 16
IMG = 256

# kernel vs plain version, both fp32 inside. fp32: sums in another order
# (and FMA contraction) move the last bits. bf16: both round one fp32 value
# once, so they differ by at most a rounding step or two of the output.
# abs tolerance is on max|kernel - plain|, rel on that over max|plain|.
TOL = {torch.float32: {"abs": 1e-4, "rel": 1e-5},
       torch.bfloat16: {"abs": 0.125, "rel": 2.0 ** -7}}

# kernels vs plain versions through the whole fp32 forward, relative to the
# largest logit: random-init logits at 256² reach ~1e7, and 16 blocks carry
# each kernel's last-bit differences forward
MODEL_REL_TOL = 1e-4

# Backward kernel vs plain backward, relative to the output's largest value:
# image-shaped gradients as TOL; dw, db are fp32 sums over B·H·W (up to
# 65,536 terms) in another order in both dtypes (the bf16 inputs are exact
# in fp32), so their last bits move more.
BWD_WEIGHT_REL_TOL = 1e-4

# The kernels line gives each kernel's times for one train step (fp32; bf16
# under "bf16") at
# D·B = 16, 256²: 2 encoder and 2 decoder blocks run at each stage shape, so
# each forward kernel runs 4 times per shape; each backward kernel 4 times
# per shape in the first pull and, in the second (domain_layer) pull, at
# every block but the first encoder block, whose kernels lie before the
# first domain gate: 3 times at stage 0.
FWD_CALLS = (4, 4, 4, 4)
BWD_CALLS = (7, 8, 8, 8)
FORWARD = ("factorized_attention", "cpe_conv", "crpe_conv")
BACKWARD = ("factorized_attention_bwd", "cpe_conv_bwd", "crpe_conv_bwd")
REPLACES = {
    "factorized_attention": "mdvit_tpu/ops/pallas_attention.py:144",
    "cpe_conv": "mdvit_tpu/ops/pallas_dwconv.py:194",
    "crpe_conv": "mdvit_tpu/ops/pallas_dwconv.py:251",
    "factorized_attention_bwd": "mdvit_tpu/ops/pallas_attention.py:175",
    "cpe_conv_bwd": "mdvit_tpu/ops/pallas_dwconv.py:216",
    "crpe_conv_bwd": "mdvit_tpu/ops/pallas_dwconv.py:274",
}
SOURCE = {name: "mdvit_tpu_torch/csrc/" + (
    "factorized_attention.cu" if name.startswith("factorized") else "dwconv.cu")
    for name in REPLACES}
# device-kernel names of the port's own kernels, for the profiler's share
PORT_KERNEL_NAMES = ("factorized_attention_fwd_partials_kernel",
                     "factorized_attention_fwd_apply_kernel",
                     "factorized_attention_bwd_partials_kernel",
                     "factorized_attention_bwd_apply_kernel",
                     "dwconv_fwd_tiled_kernel", "dwconv_bwd_tiled_kernel",
                     "dwconv_weight_reduce_kernel")
# device launches of one A, A′, B′ or C′ call: A's and A′'s partials and
# apply kernels, B′'s and C′'s fused tile kernel and reduce
SPLIT_LAUNCHES = 2
# the serving caller's batch, at which phases 2 and split also time A
B1 = 1

# the train step: D domains × B per domain, N images per domain store
TRAIN_D, TRAIN_B, TRAIN_N = 4, 4, 8
# gradients through the kernels vs through the plain versions, per parameter:
# relative to the tensor's largest |grad|, with a floor at that share of the
# model's largest |grad| for leaves whose true gradient is zero (a conv bias
# ahead of a BatchNorm holds only cancellation noise). The fp32 step chains
# 16 blocks of kernels with last-bit differences through two backward pulls.
GRAD_REL_TOL = 1e-3
GRAD_FLOOR_REL = 1e-5
# the same step with the forwards plain too: forward activations then differ
# in their last bits (the logits by ~3e-6 of their scale), and a few tensors'
# gradients by up to a few percent, more or fewer with each set of dropout
# masks; so the step is held as a whole, by the relative L2 norm over all
# gradients. On an H100 it read 5e-6 to 9.5e-4 over the mask sets tried; the
# limit is about four times the largest
GRAD_L2_TOL = 4e-3
# the heads' weights and biases times this make the first step's logits O(1)
# (the random-init logits reach tens, where the sigmoid saturates)
UNSATURATED_HEAD_SCALE = 1e-2

# augmentation, card against CPU, images before normalisation: the noise's
# log and cos round as each libm does, which can move its floor by one level;
# through the warp's blend (weights summing to 1) and the contrast (α ≤ 1.2)
# such a value then differs by at most AUG_FLOOR_STEP, and at most
# AUG_FLOOR_SHARE of the values may differ at all
AUG_FLOOR_SHARE = 1e-3
AUG_FLOOR_STEP = 1.25

# the trainer phase: synthetic (train, test) images per domain, epochs of
# the first Trainer
TRAINER_SIZES = (32, 10)
TRAINER_EPOCHS = 2
TRAINER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_trainer"

# the family phase: row id → (registry name, adapt_method, decoder_name),
# and the launches of A/B/C and of A′/B′/C′ predicted for one train step:
# 16 blocks each; MKD with the Sup gate adds the second pull (15 blocks lie
# after the first gate); MDViTᵀ's 4 debranches run 8 blocks each on their
# own group, in both pulls (the KT loss reads the aux logits)
FAMILY = {
    "BASE": ("BASE", None, None, (16, 16)),
    "BASE_Sup": ("BASE", "Sup", None, (16, 16)),
    "BASE_DSN": ("BASE_DSN", None, None, (16, 16)),
    "BASE_DASE": ("BASE_DASE", None, None, (16, 16)),
    "BASE_USE": ("BASE_USE", None, None, (16, 16)),
    "MDViT_DSN": ("MDViT_DSN", "Sup", "MLPFM", (16, 31)),
    "MDViT_MLP": ("MDViT", "Sup", "MLP", (16, 31)),
    "MDViT_DeepLabV3": ("MDViT", "Sup", "DeepLabV3", (16, 31)),
    "MDViT_Transformer": ("MDViT", "Sup", "Transformer", (48, 95)),
    "MDViT_noSup": ("MDViT", None, "MLPFM", (16, 16)),
}
# steps timed per dtype (after 1 warm-up step) and profiled; train-mode
# forwards that set the BN running stats before the serving check
FAMILY_STEPS, FAMILY_PROFILED, FAMILY_BN_PASSES = 3, 1, 20
# the family_cli phase: (train, test) images a domain, and its rows
FAMILY_CLI_SIZES = (8, 4)
FAMILY_CLI_ROWS = ("BASE_DSN", "MDViT_Transformer")
FAMILY_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_family"
# the export phase: the models exported at B=16 in fp32 and bf16 (MDViT and
# BASE_DSN, the norm case), and the serving calls timed of each program
EXPORT_ROWS = ("MDViT", "BASE_DSN")
EXPORT_TIMED = 10
# the remat phase: model → launches of A/B/C and of A′/B′/C′ predicted for
# one remat train step: each backward pull recomputes the forward once (MDViT
# with the Sup gate pulls twice: 16 × 3 forward, 16 + 15 backward; BASE once)
REMAT = {"MDViT": (48, 31), "BASE": (32, 16)}
REMAT_STEPS = 3
# the kfold_cli phase: two folds of the CLI (debug: one step, one eval batch
# a domain) of MDViT at full width with one block a stage, img 64, bf16, then
# the aggregate, the summary and the export CLI's check on fold 0
KFOLD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_kfold"
KFOLD_IMG = 64
KFOLD_CONFIG = {"debug": True,
                "data": {"img_size": KFOLD_IMG, "synthetic": True, "name": ["isic2018", "PH2"],
                         "synthetic_sizes": {"isic2018": [8, 4], "PH2": [8, 4]}},
                "train": {"num_epochs": 1, "batch_size": 2}, "test": {"batch_size": 4},
                "model_kwargs": {"num_layers": [1, 1, 1, 1]}}
# the determinism phase: the models whose step (augmentation on, dropout
# 0.1) is taken twice from one state with device.deterministic on (the
# control must read 0) and off, in fp32 and bf16; the row whose steps are
# timed (in alternating pairs, after 3 warm-up pairs) and profiled in each
# setting, and the pairs timed
DETERMINISM_ROWS = ("MDViT", "BASE")
DETERMINISM_COST_ROW = "MDViT"
DETERMINISM_PAIRS = 4
# the separable resize against F.interpolate's forward, relative to the
# largest value, at the logits' 64² → 256²
RESIZE_REL_TOL = 1e-6
# the dp phase: the flagship step (fp32, augmentation and dropout on) with
# SGD as JAX's sharding test takes it; DP_WORLD gloo ranks on the one card,
# each its D·B / DP_WORLD rows; the loss and the BN running stats held to
# DP_REL_TOL of their scale (sums in another order), the gradients and
# updates to GRAD_L2_TOL; steps timed in each setting
DP_WORLD = 2
DP_LR = 1e-2
DP_REL_TOL = 1e-5
DP_TIMED = 3
DP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
# the zoo phase: the segmentation comparators at full width, 256², trained
# and served through the entry points (none reaches the six kernels); the
# card against the host CPU at ZOO_CPU_B images, relative to max(1, max|logit|);
# steps timed a dtype (after one warm-up); TransFuse_L_384's batch; the CLI
# run's (train, test) images a domain; extract_features' datasets (their
# synthetic train splits, 24 images each) and its tolerance relative to the
# largest feature
ZOO = ("UTNet", "SwinUnet", "SwinUNETR", "TransFuse_S", "TransFuse_S_adapt", "TransFuse_L")
ZOO_CPU_B = 2
ZOO_LOGIT_TOL = 1e-4
ZOO_STEPS = 3
ZOO_L384_B = 2
ZOO_CLI_SIZES = (8, 4)
ZOO_FEATURE_SETS = ("isic2018", "PH2")
ZOO_FEATURE_TOL = 1e-4
ZOO_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_zoo"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """CUDA events around ``iters`` eager calls: at small shapes this is the
    host's launch cost, not the kernel's."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: CUDA events around one replay of a CUDA graph
    that holds ``iters`` calls, so no host launch cost is between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def compare(got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    tol = TOL[dtype]
    ok = (err <= tol["abs"] and rel <= tol["rel"]
          and bool(torch.isfinite(got.float()).all()))
    return {"max_abs_err": err, "max_rel_err": rel, "scale": scale,
            "tol_abs": tol["abs"], "tol_rel": tol["rel"], "ok": ok}


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phase 1


def phase_build() -> None:
    info = kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "ptxas": info["ptxas"]})
    for name, entries in info["ptxas"].items():
        if not entries:
            raise RuntimeError(f"no ptxas report for {name}")


# ----------------------------------------------------------------- phase 2


def _inputs(kind: str, h: int, w: int, c: int, dtype, gen, batch: int | None = None) -> dict:
    """Kernel inputs as the main path gives them, ``batch`` (default BATCH)
    images: q, k, v are slices of one (B, N, 3C) projection (row stride 3C);
    CPE's x is a contiguous grid."""
    batch = batch or BATCH
    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    if kind == "factorized_attention":
        qkv = randn(batch, h * w, 3 * c)
        return {"q": qkv[..., :c], "k": qkv[..., c:2 * c], "v": qkv[..., 2 * c:]}
    if kind == "cpe_conv":
        return {"x": randn(batch, h, w, c), "w": randn(3, 3, c, std=(2 / 9) ** 0.5),
                "b": randn(c, std=0.1)}
    qkv = randn(batch, h, w, 3 * c)
    return {"q": qkv[..., :c], "v": qkv[..., 2 * c:],
            "w": randn(7, 7, c, std=(2 / 49) ** 0.5), "b": randn(c, std=0.1)}


def _summary(names) -> dict:
    return {name: {"max_abs_err": 0.0, "bound_by": set(),
                   **{d: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
                      for d in ("float32", "bfloat16")}} for name in names}


def _add(s: dict, rec: dict, calls: int) -> None:
    """Fold one shape's record into a kernel's per-train-step totals of its
    dtype (``calls`` calls at this shape); errors over both dtypes."""
    s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
    tot = s[rec["dtype"]]
    for k in ("ms", "plain_ms", "bound_ms"):
        tot[k] += calls * rec[k]
    if rec["library_ms"] is not None:
        tot["library_ms"] = (tot["library_ms"] or 0.0) + calls * rec["library_ms"]
    if rec["dtype"] == "float32":
        s["bound_by"].add(rec["bound_by"])


def phase_kernels(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    summary = _summary(FORWARD)
    failures = []
    for kind in FORWARD:
        for stage, (h, w, c, ch) in enumerate(STAGES):
            for dtype in (torch.float32, torch.bfloat16):
                t = _inputs(kind, h, w, c, dtype, gen)
                item = 2 if dtype == torch.bfloat16 else 4
                n_el = BATCH * h * w * c
                lib_fn = None
                if kind == "factorized_attention":
                    scale = ch ** -0.5
                    run = lambda: fa.factorized_attention(t["q"], t["k"], t["v"], ch, scale)
                    plain = lambda: fa.factorized_attention_ref(t["q"], t["k"], t["v"], ch, scale)
                    n_bytes, flops = 4 * n_el * item, 4 * n_el * ch
                elif kind == "cpe_conv":
                    run = lambda: dwconv.cpe_conv(t["x"], t["w"], t["b"])
                    plain = lambda: dwconv.cpe_conv_ref(t["x"], t["w"], t["b"])
                    n_bytes = 2 * n_el * item + (9 * c + c) * item
                    flops = 2 * 9 * n_el + 2 * n_el
                    w_oihw = t["w"].permute(2, 0, 1).unsqueeze(1).contiguous()
                    x_nchw = t["x"].permute(0, 3, 1, 2)
                    lib_fn = lambda: F.conv2d(x_nchw, w_oihw, t["b"], padding=1, groups=c)
                else:
                    run = lambda: dwconv.crpe_conv(t["q"], t["v"], t["w"], t["b"])
                    plain = lambda: dwconv.crpe_conv_ref(t["q"], t["v"], t["w"], t["b"])
                    n_bytes = 3 * n_el * item + (49 * c + c) * item
                    flops = 2 * 49 * n_el + 2 * n_el
                    w_oihw = t["w"].permute(2, 0, 1).unsqueeze(1).contiguous()
                    v_nchw = t["v"].permute(0, 3, 1, 2)
                    lib_fn = lambda: F.conv2d(v_nchw, w_oihw, t["b"], padding=3, groups=c)
                got = run()
                torch.cuda.synchronize()
                res = compare(got, plain(), dtype)
                with torch.no_grad():
                    ms = device_ms(run)
                    ms_eager = eager_ms(run)
                    plain_ms = device_ms(plain)
                    library_ms = device_ms(lib_fn) if lib_fn else None
                b_ms, b_by = bound_ms(n_bytes, flops)
                rec = {"phase": "kernel", "kernel": kind, "B": BATCH, "H": h, "W": w,
                       "C": c, "ch": ch if kind == "factorized_attention" else None,
                       "dtype": str(dtype).replace("torch.", ""), **res, "ms": ms,
                       "eager_ms": ms_eager,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                       "flops": flops, "roofline_share": b_ms / ms}
                emit(rec)
                if not res["ok"]:
                    failures.append(rec)
                _add(summary[kind], rec, FWD_CALLS[stage])
                del t, got
    failures += [r for r in attention_b1(seed) if not r["ok"]]
    if failures:
        raise RuntimeError(f"{len(failures)} kernel check(s) out of tolerance")
    return summary


def attention_b1(seed: int) -> list:
    """A at B=1 at each stage shape in fp32 and bf16 (``kernel_b1``
    records): the check against the plain version, device ms of the kernel
    and of the plain version, and the bound. Uses only the wrapper's public
    call, so it times any tree's package."""
    gen = torch.Generator().manual_seed(seed + 3)
    out = []
    for (h, w, c, ch), dtype in itertools.product(STAGES, (torch.float32, torch.bfloat16)):
        q, k, v = _inputs("factorized_attention", h, w, c, dtype, gen, B1).values()
        run = lambda: fa.factorized_attention(q, k, v, ch, ch ** -0.5)
        plain = lambda: fa.factorized_attention_ref(q, k, v, ch, ch ** -0.5)
        got = run()
        torch.cuda.synchronize()
        res = compare(got, plain(), dtype)
        with torch.no_grad():
            ms = device_ms(run)
            plain_ms = device_ms(plain)
        n_el = B1 * h * w * c
        n_bytes, flops = 4 * n_el * q.element_size(), 4 * n_el * ch
        b_ms, b_by = bound_ms(n_bytes, flops)
        rec = {"phase": "kernel_b1", "kernel": "factorized_attention", "B": B1, "H": h,
               "W": w, "C": c, "ch": ch, "dtype": str(dtype).replace("torch.", ""), **res,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "roofline_share": b_ms / ms}
        emit(rec)
        out.append(rec)
        del q, k, v, got
    return out


# ----------------------------------------------------------------- phase 3


def _weights_apart(grads, w):
    """A CPE or CRPE backward op's outputs with its stacked (K·K + 1, C)
    fp32 weight gradient split into dw (K, K, C) and db (C,), as the plain
    backwards return them; A′'s (``w`` None) as they are."""
    if w is None:
        return grads
    *image, dwb = grads
    return (*image, dwb[:-1].view(w.shape), dwb[-1])


def _compare_grads(got, want, dtype, n_image: int) -> dict:
    """Image-shaped gradients (the first ``n_image``) as ``compare``; dw, db
    (fp32 in both dtypes) relative to their largest value."""
    res = {"max_abs_err": 0.0, "max_rel_err": 0.0, "weight_rel_err": 0.0, "ok": True}
    for i, (a, e) in enumerate(zip(got, want)):
        if i < n_image:
            r = compare(a, e, dtype)
            res["max_rel_err"] = max(res["max_rel_err"], r["max_rel_err"])
            res["ok"] &= r["ok"]
            res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        else:
            err = (a.float() - e.float()).abs().max().item()
            rel = err / max(e.float().abs().max().item(), 1e-30)
            res["weight_rel_err"] = max(res["weight_rel_err"], rel)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["ok"] &= rel <= BWD_WEIGHT_REL_TOL and bool(torch.isfinite(a).all())
    return res


def phase_backward(seed: int) -> dict:
    """A′, B′, C′ through their wrappers against the plain backwards, at the
    main path's shapes: q, k, v (and CRPE's q, v) as slices of one
    projection, the output gradient contiguous."""
    gen = torch.Generator().manual_seed(seed + 7)
    summary = _summary(BACKWARD)
    failures = []
    for kind in BACKWARD:
        for stage, (h, w, c, ch) in enumerate(STAGES):
            for dtype in (torch.float32, torch.bfloat16):
                t = _inputs(kind[:-4], h, w, c, dtype, gen)
                item = 2 if dtype == torch.bfloat16 else 4
                n_el = BATCH * h * w * c
                lib_fn = None
                if kind == "factorized_attention_bwd":
                    scale = ch ** -0.5
                    g = torch.randn(BATCH, h * w, c, generator=gen).to("cuda", dtype)
                    args = (t["q"], t["k"], t["v"], g, ch, scale)
                    run = lambda: torch.ops.mdvit.factorized_attention_bwd(*args)
                    plain = lambda: fa.factorized_attention_bwd_ref(*args)
                    n_image, n_bytes, flops = 3, 7 * n_el * item, 10 * n_el * ch
                else:
                    g = torch.randn(BATCH, h, w, c, generator=gen).to("cuda", dtype)
                    k = 3 if kind == "cpe_conv_bwd" else 7
                    w_oihw = t["w"].permute(2, 0, 1).unsqueeze(1).contiguous()
                    g_nchw = g.permute(0, 3, 1, 2)
                    if kind == "cpe_conv_bwd":
                        args = (t["x"], t["w"], g)
                        run = lambda: torch.ops.mdvit.cpe_conv_bwd(*args)
                        plain = lambda: dwconv.cpe_conv_bwd_ref(*args)
                        n_image = 1
                        n_bytes = 3 * n_el * item + 9 * c * item + 10 * c * 4
                        flops = 4 * 9 * n_el + 2 * n_el
                        img = t["x"]
                    else:
                        args = (t["q"], t["v"], t["w"], t["b"], g)
                        run = lambda: torch.ops.mdvit.crpe_conv_bwd(*args)
                        plain = lambda: dwconv.crpe_conv_bwd_ref(*args)
                        n_image = 2
                        n_bytes = 5 * n_el * item + 50 * c * item + 50 * c * 4
                        flops = 6 * 49 * n_el + 4 * n_el
                        img = t["v"]
                    img_nchw = img.permute(0, 3, 1, 2)
                    pad = [k // 2] * 2
                    lib_fn = lambda: torch.ops.aten.convolution_backward(
                        g_nchw, img_nchw, w_oihw, [c], [1, 1], pad, [1, 1], False,
                        [0, 0], c, [True, True, True])
                got = run()
                again = run()
                torch.cuda.synchronize()
                res = _compare_grads(_weights_apart(got, t.get("w")), plain(), dtype, n_image)
                res["bit_equal_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
                res["ok"] &= res["bit_equal_repeat"]
                with torch.no_grad():
                    ms = device_ms(run)
                    ms_eager = eager_ms(run)
                    plain_ms = device_ms(plain)
                    library_ms = device_ms(lib_fn) if lib_fn else None
                b_ms, b_by = bound_ms(n_bytes, flops)
                rec = {"phase": "kernel", "kernel": kind, "B": BATCH, "H": h, "W": w,
                       "C": c, "ch": ch if kind.startswith("factorized") else None,
                       "dtype": str(dtype).replace("torch.", ""), **res, "ms": ms,
                       "eager_ms": ms_eager, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "bytes": n_bytes, "flops": flops, "roofline_share": b_ms / ms}
                emit(rec)
                if not res["ok"]:
                    failures.append(rec)
                _add(summary[kind], rec, BWD_CALLS[stage])
                del t, got, again, lib_fn
    if failures:
        raise RuntimeError(f"{len(failures)} backward kernel check(s) failed")
    return summary


def phase_split(seed: int) -> None:
    """A's launches per call at B=16 and B=1, A′'s, B′'s and C′'s at B=16, and
    device ms per launch at each stage shape; fails unless every call is
    ``SPLIT_LAUNCHES`` device launches."""
    bad = [(r["kernel"], r["B"], r["H"], r["dtype"], r["launches_per_call"])
           for r in split(seed) if r["launches_per_call"] != SPLIT_LAUNCHES]
    if bad:
        raise RuntimeError(f"calls are not {SPLIT_LAUNCHES} device launches: {bad}")


def split(seed: int, reps: int = 10) -> list:
    """Device launches per call and device ms per launch, by device-kernel
    name, at each stage shape in fp32 and bf16 (``torch.profiler`` over
    ``reps`` calls of ``fa.factorized_attention`` under ``no_grad`` at B=16
    and B=1, and of the backward ops ``torch.ops.mdvit.*_bwd`` at B=16, on
    the main path's inputs)."""
    gen = torch.Generator().manual_seed(seed + 11)
    kinds = [(FORWARD[0], BATCH), (FORWARD[0], B1), *((kind, BATCH) for kind in BACKWARD)]
    out = []
    for (kind, bsz), (h, w, c, ch), dtype in itertools.product(
            kinds, STAGES, (torch.float32, torch.bfloat16)):
        t = _inputs(kind.removesuffix("_bwd"), h, w, c, dtype, gen, bsz)
        g = None
        if kind == "factorized_attention":
            call = lambda: fa.factorized_attention(t["q"], t["k"], t["v"], ch, ch ** -0.5)
        elif kind == "factorized_attention_bwd":
            g = torch.randn(bsz, h * w, c, generator=gen).to("cuda", dtype)
            call = lambda: torch.ops.mdvit.factorized_attention_bwd(t["q"], t["k"], t["v"], g,
                                                                    ch, ch ** -0.5)
        elif kind == "cpe_conv_bwd":
            g = torch.randn(bsz, h, w, c, generator=gen).to("cuda", dtype)
            call = lambda: torch.ops.mdvit.cpe_conv_bwd(t["x"], t["w"], g)
        elif kind == "crpe_conv_bwd":
            g = torch.randn(bsz, h, w, c, generator=gen).to("cuda", dtype)
            call = lambda: torch.ops.mdvit.crpe_conv_bwd(t["q"], t["v"], t["w"], t["b"], g)
        with torch.no_grad():
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            # a profiler window now and then records no device events, or only
            # some (on an H100: 2 records of ~170, one of them in 3 windows in
            # a row): take another window, after a pause, while the count is
            # not a whole number a call
            for attempt in range(10):
                if attempt:
                    time.sleep(0.2)
                    torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        call()
                    torch.cuda.synchronize()
                by_name: dict = defaultdict(lambda: [0, 0.0])
                for e in prof.events():
                    if (e.device_type == torch.autograd.DeviceType.CUDA
                            and not getattr(e, "is_user_annotation", False)):
                        by_name[e.name][0] += 1
                        by_name[e.name][1] += e.time_range.end - e.time_range.start
                n_launches = sum(n for n, _ in by_name.values())
                if n_launches and n_launches % reps == 0:
                    break
        rec = {"phase": "split", "kernel": kind, "B": bsz, "H": h,
               "W": w, "C": c, "dtype": str(dtype).replace("torch.", ""),
               "windows": attempt + 1,
               "launches_per_call": sum(n for n, _ in by_name.values()) / reps,
               "ms_per_call": sum(us for _, us in by_name.values()) / reps / 1e3,
               "split": [{"name": name[:120], "launches_per_call": n / reps,
                          "ms_per_launch": us / n / 1e3}
                         for name, (n, us) in sorted(by_name.items())]}
        emit(rec)
        out.append(rec)
        del t, g, call
    return out


# ----------------------------------------------------------------- phase 4


@contextlib.contextmanager
def plain_versions(forward: bool = True):
    """Route the model's kernel calls to their plain PyTorch versions: the
    backwards always, the forwards too unless ``forward`` is False. The ops'
    CUDA implementations call the plain versions (the ops' CPU
    implementations, which run on any device's tensors) in place of their
    launches; the ops and their autograd stay the same."""
    patches = [(fa, "_backward", fa._attention_bwd_cpu),
               (dwconv, "_cpe_backward", dwconv._cpe_bwd_cpu),
               (dwconv, "_crpe_backward", dwconv._crpe_bwd_cpu)]
    if forward:
        patches += [(fa, "_forward", fa._attention_cpu),
                    (dwconv, "_cpe_forward", dwconv._cpe_cpu),
                    (dwconv, "_crpe_forward", dwconv._crpe_cpu)]
    with contextlib.ExitStack() as stack:
        for module, name, fn in patches:
            stack.enter_context(mock.patch.object(module, name, fn))
        yield


def _requests(batch: int, seed: int):
    """A batch of 0..255 RGB images at 256² and mixed-domain one-hots."""
    gen = torch.Generator().manual_seed(seed + 1)
    images = torch.randint(0, 256, (batch, IMG, IMG, 3), generator=gen).float()
    onehot = torch.eye(4)[torch.arange(batch) % 4]
    return images.cuda(), onehot.cuda()


def _time_calls(fn, batch: int, iters: int, warmup: int = 3) -> dict:
    """Host clock around each ``fn()`` ended by a synchronize, after ``warmup``
    calls; ``batch`` images per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat.sort()
    mean = sum(lat) / len(lat)
    p50 = lat[len(lat) // 2]
    return {"latency_ms_mean": mean * 1e3, "latency_ms_p50": p50 * 1e3,
            "latency_ms_min": lat[0] * 1e3, "img_per_s": batch / mean,
            "img_per_s_p50": batch / p50, "iters": iters}


def _is_attention_fwd(name: str) -> bool:
    """A device kernel of A: its partials or its apply kernel."""
    return any(k in name for k in ("factorized_attention_fwd_partials_kernel",
                                   "factorized_attention_fwd_apply_kernel"))


def _profile_calls(fn, reps: int = 5, cpu: bool = True) -> dict:
    """Device work of ``reps`` calls under ``torch.profiler``: busy time (the
    union of device-op intervals) per call, device ops (kernels, copies,
    memsets) per call, the port kernels' share of device time, A's device ms
    per call and share, top ops. ``cpu=False`` traces the device alone (no
    host events to parse: the same device numbers, faster)."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device ops only: record_function ranges (the optimizer's step) appear
    # on the device timeline as user annotations spanning other ops
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not ops:
        raise RuntimeError("the profiler recorded no device work")
    spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
    busy = 0.0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = defaultdict(float)
    for e in ops:
        by_name[e.name] += e.time_range.end - e.time_range.start
    total = sum(by_name.values())
    ours = sum(t for n, t in by_name.items() if any(k in n for k in PORT_KERNEL_NAMES))
    attn = sum(t for n, t in by_name.items() if _is_attention_fwd(n))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy / reps / 1e3, "device_ops_per_call": len(ops) / reps,
            "port_kernels_share": ours / total,
            "attention_fwd_ms_per_call": attn / reps / 1e3, "attention_fwd_share": attn / total,
            "top": [{"name": n[:80], "ms_per_call": t / reps / 1e3} for n, t in top]}


def phase_model(seed: int) -> dict:
    model = build_mdvit(img_size=IMG, num_domains=4, dtype=torch.float32,
                        device="cuda", seed=seed)
    forward = make_forward(model)
    images, onehot = _requests(BATCH, seed)

    # the main path: one serving call, every launch counter read around it
    kernels.reset_launches()
    probs = forward(images, onehot)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    emit({"phase": "model", "B": BATCH, "img": IMG, "launches": launches})
    # 8 encoder + 8 decoder serial blocks, one call each; no backward
    expected = {name: 16 if name in FORWARD else 0 for name in launches}
    if launches != expected:
        raise RuntimeError(f"launch counts {launches}, want {expected}")
    if (tuple(probs.shape) != (BATCH, IMG, IMG) or not bool(torch.isfinite(probs).all())
            or probs.min().item() < 0 or probs.max().item() > 1):
        raise RuntimeError(f"bad probabilities, shape {tuple(probs.shape)}")

    # the logits through the kernels against the plain versions
    x = normalize(images)
    with torch.no_grad():
        out = model(x, onehot, out_feat=True)
        with plain_versions():
            kernels.reset_launches()
            plain = model(x, onehot, out_feat=True)
            torch.cuda.synchronize()
            plain_launches = dict(kernels.LAUNCHES)
    logits = out["seg"][0]
    if tuple(logits.shape) != (BATCH, IMG, IMG, 1) or out["seg"][1] is not None:
        raise RuntimeError(f"unexpected output shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(out["feat"]).all()):
        raise RuntimeError("non-finite logits or feat")
    scale = plain["seg"][0].abs().max().item()
    rel = (logits - plain["seg"][0]).abs().max().item() / scale
    feat_rel = ((out["feat"] - plain["feat"]).abs().max().item()
                / plain["feat"].abs().max().item())
    emit({"phase": "model_vs_plain", "B": BATCH, "logit_scale": scale,
          "logit_rel_err": rel, "feat_rel_err": feat_rel, "tol_rel": MODEL_REL_TOL,
          "plain_launches": plain_launches})
    if any(plain_launches.values()):
        raise RuntimeError(f"plain forward launched kernels: {plain_launches}")
    if not (rel <= MODEL_REL_TOL and feat_rel <= MODEL_REL_TOL):
        raise RuntimeError(f"kernel forward differs from plain: {rel}, {feat_rel}")
    del plain, out

    model_bf16 = build_mdvit(img_size=IMG, num_domains=4, dtype=torch.bfloat16,
                             device="cuda", seed=seed)
    with torch.no_grad():
        l16 = model_bf16(x, onehot)["seg"][0].float()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(l16).all()):
        raise RuntimeError("non-finite bf16 logits")
    emit({"phase": "model_bf16", "B": BATCH,
          "logit_rel_err_vs_fp32": (l16 - logits).abs().max().item() / scale})
    del l16, logits, x

    for name, m in (("float32", model), ("bfloat16", model_bf16)):
        for batch in (1, BATCH):
            emit(serving(m, name, batch, seed))
    return launches


def _reset_peak() -> int:
    """Free the cuBLAS workspaces that earlier phases left allocated, one for
    each stream a product ran on (``device_ms`` takes a side stream from the
    pool each call), then reset the peak to what is allocated now: the peak
    read after it counts the live tensors and the measured calls' own
    workspaces, not the process's history. Returns the bytes the clear freed."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    freed = before - torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return freed


def serving(model, dtype_name: str, batch: int, seed: int) -> dict:
    """One ``serving`` record: latency and img/s of ``make_forward(model)`` at
    ``batch``, its peak memory, and a profiler window of the same calls."""
    fwd = make_forward(model)
    images, onehot = _requests(batch, seed)
    freed = _reset_peak()
    call = lambda: fwd(images, onehot)
    t = _time_calls(call, batch, iters=50 if batch == 1 else 30)
    peak = torch.cuda.max_memory_allocated()
    p = _profile_calls(call)
    return {"phase": "serving", "dtype": dtype_name, "B": batch, "img": IMG, **t,
            "peak_mem_bytes": peak, "cublas_workspaces_freed_bytes": freed, **p,
            "idle_share": 1 - p["device_busy_ms"] / t["latency_ms_mean"]}


# ----------------------------------------------------------------- phase 5


def _stores(seed: int):
    """Per-domain uint8 stores on the card, ``TRAIN_N`` each: a disc mask per
    image, and the image brighter inside its disc than around it."""
    gen = torch.Generator().manual_seed(seed + 2)
    yy, xx = torch.meshgrid(torch.arange(IMG), torch.arange(IMG), indexing="ij")
    images, masks = [], []
    for _ in range(TRAIN_D):
        cy, cx = torch.randint(64, 192, (2, TRAIN_N, 1, 1), generator=gen)
        r = torch.randint(24, 64, (TRAIN_N, 1, 1), generator=gen)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        noise = torch.randint(0, 160, (TRAIN_N, IMG, IMG, 3), generator=gen)
        images.append((noise + 90 * m[..., None]).clamp(0, 255).to(torch.uint8).cuda())
        masks.append(m.to(torch.uint8).cuda())
    return images, masks


def _train_setup(dtype, seed: int, drop: float = 0.1, head_scale: float = 1.0):
    """The full-width MDViT (dropout and stochastic depth ``drop``, 0.1 as the
    reference trains it; the heads' parameters times ``head_scale``) with
    AdamW + StepLR from the default config, its MKD train step without
    augmentation and the flagship step, with augmentation, on the same model
    and optimizer."""
    model = build_mdvit(img_size=IMG, num_domains=TRAIN_D, dtype=dtype, device="cuda",
                        seed=seed, drop_rate=drop, drop_path_rate=drop)
    if head_scale != 1.0:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("finalconv.") or ".linear_out." in name:
                    p.mul_(head_scale)
    optimizer, scheduler = build_optimizer(model, TRAIN_N // TRAIN_B, load_config())
    step = make_train_step(model, optimizer, scheduler, TRAIN_D, seed=seed,
                           device_augment=False)
    return model, step, make_train_step(model, optimizer, scheduler, TRAIN_D, seed=seed)


def _grad_check(model, plain_model) -> dict:
    grads = {n: p.grad for n, p in model.named_parameters()}
    plain = {n: p.grad for n, p in plain_model.named_parameters()}
    top = max(g.abs().max().item() for g in plain.values())
    worst, worst_name, n_bad = 0.0, None, 0
    for name, want in plain.items():
        err = (grads[name] - want).abs().max().item()
        limit = GRAD_REL_TOL * max(want.abs().max().item(), GRAD_FLOOR_REL * top)
        ratio = err / limit
        n_bad += int(not ratio <= 1.0)
        if not ratio <= worst:
            worst, worst_name = ratio, name
    return {"n_params": len(plain), "largest_grad": top, "worst_err_over_limit": worst,
            "worst_param": worst_name, "n_out_of_tolerance": n_bad,
            "tol_rel": GRAD_REL_TOL, "floor_rel": GRAD_FLOOR_REL,
            "grad_l2_rel_err": _grad_l2_rel(model, plain_model)}


def _grad_l2_rel(model, plain_model) -> float:
    """‖grads − plain grads‖ / ‖plain grads‖ over all parameters."""
    num = sum(((p.grad - q.grad) ** 2).sum().item()
              for p, q in zip(model.parameters(), plain_model.parameters()))
    den = sum((q.grad ** 2).sum().item() for q in plain_model.parameters())
    return (num / den) ** 0.5


def _all_plain_gap(seed: int, batch, drop: float, head_scale: float) -> dict:
    """One fp32 step through the kernels and one through all plain versions,
    from the same weights: the gradient gap and the first step's loss."""
    models, losses = [], []
    for plain in (False, True):
        model, step, _ = _train_setup(torch.float32, seed, drop, head_scale)
        with plain_versions() if plain else contextlib.nullcontext():
            losses.append(step(*batch)["loss"].item())
        models.append(model)
    check = _grad_check(*models)
    return {"drop": drop, "head_scale": head_scale, "loss": losses[1],
            **{k: check[k] for k in ("grad_l2_rel_err", "worst_err_over_limit",
                                     "worst_param", "n_out_of_tolerance")}}


def phase_augment(seed: int) -> dict:
    """The augmentation's device cost per step and the card against the CPU."""
    images, masks = _stores(seed)
    indices = torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda()
    batch = TRAIN_D * TRAIN_B
    x_raw, m_raw, _ = gather_batch(images, masks, indices)
    dev = x_raw.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    call = lambda: augment_batch(gen, x_raw, m_raw)
    t = _time_calls(call, batch, iters=20)
    p = _profile_calls(call, reps=5)
    noise_seed = torch.tensor(seed + 12345, dtype=torch.int64, device=dev)
    shape = tuple(x_raw.shape)
    noise = _profile_calls(lambda: fast_normal(noise_seed, shape, dev), reps=5)
    stream = _profile_calls(lambda: fast_uniform(noise_seed, shape, dev, offset=1), reps=5)
    # fast_normal hashes two uniform streams of the batch's shape
    hash_ms = 2 * stream["device_busy_ms"]
    rec = {"phase": "augment", "D": TRAIN_D, "B": TRAIN_B, "img": IMG,
           "device_ms": p["device_busy_ms"], "device_ops": p["device_ops_per_call"],
           "wall_ms_mean": t["latency_ms_mean"], "wall_ms_p50": t["latency_ms_p50"],
           "noise_device_ms": noise["device_busy_ms"],
           "noise_share": noise["device_busy_ms"] / p["device_busy_ms"],
           "hash_device_ms": hash_ms, "hash_share": hash_ms / p["device_busy_ms"],
           "hash_device_ops": 2 * stream["device_ops_per_call"], "top": p["top"]}

    # the card against the CPU, same uint8 inputs and parameters
    params = sample_aug_params(gen, batch, dev)
    got_x, got_m = augment_raw(x_raw, m_raw, params)
    want_x, want_m = augment_raw(x_raw.cpu(), m_raw.cpu(),
                                 {k: v.cpu() for k, v in params.items()})
    diff = (got_x.cpu() - want_x).abs()
    n_diff = int((diff > 0).sum())
    rec.update(masks_equal=bool(torch.equal(got_m.cpu(), want_m)),
               images_n_differ=n_diff, images_share_differ=n_diff / diff.numel(),
               images_max_abs_diff=diff.max().item(), tol_share=AUG_FLOOR_SHARE,
               tol_step=AUG_FLOOR_STEP, applied={k: int(params[k].sum()) for k in (
                   "noise_apply", "flip_h", "flip_v", "bc_apply")},
               warped=int((params["angle"] != 0).sum()))
    emit(rec)
    if not (rec["masks_equal"] and n_diff <= AUG_FLOOR_SHARE * diff.numel()
            and rec["images_max_abs_diff"] <= AUG_FLOOR_STEP):
        raise RuntimeError(f"augmentation on the card differs from the CPU: {rec}")
    return rec


def phase_train(seed: int, augment: dict) -> dict:
    images, masks = _stores(seed)
    indices = torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda()  # one fixed batch
    batch = TRAIN_D * TRAIN_B
    model, step, flagship = _train_setup(torch.float32, seed)

    # the main path: one train step, every launch counter read around it
    kernels.reset_launches()
    metrics = step(images, masks, indices)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expected = {name: sum(FWD_CALLS) if name in FORWARD else sum(BWD_CALLS)
                for name in launches}
    emit({"phase": "train", "D": TRAIN_D, "B": TRAIN_B, "img": IMG,
          "launches": launches, "expected": expected,
          "metrics": {k: v.tolist() for k, v in metrics.items()}})
    if launches != expected:
        raise RuntimeError(f"train-step launch counts {launches}, want {expected}")

    # every gradient against the same step through the plain backwards, the
    # forward kernels kept: both backwards then see bit-equal activations
    plain_model, plain_step, _ = _train_setup(torch.float32, seed)
    with plain_versions(forward=False):
        kernels.reset_launches()
        plain_step(images, masks, indices)
        torch.cuda.synchronize()
        plain_launches = dict(kernels.LAUNCHES)
    check = _grad_check(model, plain_model)
    emit({"phase": "train_vs_plain_backward", **check, "launches": plain_launches})
    want = {name: sum(FWD_CALLS) if name in FORWARD else 0 for name in plain_launches}
    if plain_launches != want:
        raise RuntimeError(f"plain-backward step launches {plain_launches}, want {want}")
    if check["n_out_of_tolerance"]:
        raise RuntimeError(f"backward kernels' gradients differ from plain: {check}")

    # and against the step with everything plain: the forwards then differ in
    # their last bits, so the gradients agree as a whole (relative L2 norm),
    # not element-wise
    del plain_model, plain_step
    all_model, all_step, _ = _train_setup(torch.float32, seed)
    with plain_versions():
        kernels.reset_launches()
        plain_metrics = all_step(images, masks, indices)
        torch.cuda.synchronize()
        all_launches = dict(kernels.LAUNCHES)
    whole = _grad_check(model, all_model)
    loss_rel = {k: ((metrics[k] - plain_metrics[k]).abs().max()
                    / plain_metrics[k].abs().max().clamp(min=1e-30)).item()
                for k in ("loss", "aux_loss", "kt_loss")}
    emit({"phase": "train_vs_plain", **whole, "grad_l2_tol": GRAD_L2_TOL,
          "loss_rel_err": loss_rel, "launches": all_launches})
    if any(all_launches.values()):
        raise RuntimeError(f"plain train step launched kernels: {all_launches}")
    if whole["grad_l2_rel_err"] > GRAD_L2_TOL or max(loss_rel.values()) > MODEL_REL_TOL:
        raise RuntimeError(f"train step differs from plain: {whole}, {loss_rel}")
    del all_model, all_step
    # where that gap comes from: the same pair of steps without dropout, and
    # without dropout with the logits out of sigmoid saturation; readings only
    emit({"phase": "train_vs_plain_cause", "gaps": [
        _all_plain_gap(seed, (images, masks, indices), 0.0, 1.0),
        _all_plain_gap(seed, (images, masks, indices), 0.0, UNSATURATED_HEAD_SCALE)]})

    # the loss falls over 10 more AdamW steps on the same batch
    losses = [metrics["loss"].item()]
    for _ in range(10):
        losses.append(step(images, masks, indices)["loss"].item())
    model16, step16, flagship16 = _train_setup(torch.bfloat16, seed)
    m16 = step16(images, masks, indices)
    finite = {k: bool(torch.isfinite(v).all()) for k, v in (
        *(("fp32_" + k, metrics[k]) for k in ("loss", "aux_loss", "kt_loss")),
        *(("bf16_" + k, m16[k]) for k in ("loss", "aux_loss", "kt_loss")))}
    emit({"phase": "train_loss", "fp32_losses": losses,
          "bf16_first": {k: m16[k].item() for k in ("loss", "aux_loss", "kt_loss")},
          "finite": finite})
    if not all(finite.values()) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train losses not finite or not falling: {losses}, {finite}")

    # the flagship step (with augmentation), beside the same step without it,
    # the two timed in alternating pairs (the host's speed drifts)
    for name, train_step, plain_step in (("float32", flagship, step),
                                         ("bfloat16", flagship16, step16)):
        call = lambda: train_step(images, masks, indices)
        freed = _reset_peak()
        t, t_plain, extra = _time_pairs(call, lambda: plain_step(images, masks, indices),
                                        batch, pairs=10)
        peak = torch.cuda.max_memory_allocated()
        p = _profile_calls(call, reps=3)
        emit({"phase": "train_speed", "dtype": name, "D": TRAIN_D, "B": TRAIN_B,
              "img": IMG, "augment": True, "step_ms_mean": t["latency_ms_mean"],
              "step_ms_p50": t["latency_ms_p50"], "img_per_s": t["img_per_s"],
              "img_per_s_p50": t["img_per_s_p50"], "iters": t["iters"],
              "peak_mem_bytes": peak, "cublas_workspaces_freed_bytes": freed, **p,
              "idle_share": 1 - p["device_busy_ms"] / t["latency_ms_mean"],
              "augment_device_ms": augment["device_ms"],
              "no_augment_step_ms_mean": t_plain["latency_ms_mean"],
              "no_augment_step_ms_p50": t_plain["latency_ms_p50"],
              "no_augment_img_per_s": t_plain["img_per_s"],
              "augment_extra_ms_p50": extra})
    return launches


def _time_pairs(fa, fb, batch: int, pairs: int):
    """``_time_calls``' records of ``fa`` and ``fb`` timed in alternating
    pairs (``fa`` first in even pairs), and the median of the pairs'
    differences (fa − fb), ms."""
    for _ in range(3):
        fa()
        fb()
    torch.cuda.synchronize()
    lat = {fa: [], fb: []}
    for i in range(pairs):
        for fn in ((fa, fb) if i % 2 == 0 else (fb, fa)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat[fn].append(time.perf_counter() - t0)
    diffs = sorted(a - b for a, b in zip(lat[fa], lat[fb]))

    def record(ts):
        mean, p50 = sum(ts) / len(ts), sorted(ts)[len(ts) // 2]
        return {"latency_ms_mean": mean * 1e3, "latency_ms_p50": p50 * 1e3,
                "img_per_s": batch / mean, "img_per_s_p50": batch / p50, "iters": len(ts)}

    return record(lat[fa]), record(lat[fb]), diffs[len(diffs) // 2] * 1e3


def _trainer_config(seed: int, epochs: int):
    sizes = {name: list(TRAINER_SIZES) for name in ("isic2018", "PH2", "DMF", "SKD")}
    return load_config(overrides={
        "seed": seed,
        "data": {"img_size": IMG, "synthetic": True, "synthetic_sizes": sizes},
        "train": {"num_epochs": epochs, "batch_size": TRAIN_B, "save_last_every": 1}})


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


def _resume_check(first: Trainer, second: Trainer) -> dict:
    """Which parts of the resumed state are bit-equal to the first's."""
    ma, mb = first.model.state_dict(), second.model.state_dict()
    oa, ob = first.optimizer.state_dict(), second.optimizer.state_dict()
    optim_ok = (oa["param_groups"] == ob["param_groups"]
                and oa["state"].keys() == ob["state"].keys()
                and all(_same_bits(v, ob["state"][i][k])
                        for i in oa["state"] for k, v in oa["state"][i].items()))
    return {"model": ma.keys() == mb.keys() and all(_same_bits(v, mb[k]) for k, v in ma.items()),
            "optimizer": optim_ok,
            "scheduler": first.scheduler.state_dict() == second.scheduler.state_dict(),
            "generator": _same_bits(first.train_step.generator.get_state(),
                                    second.train_step.generator.get_state()),
            "aug_generator": _same_bits(first.train_step.aug_generator.get_state(),
                                        second.train_step.aug_generator.get_state()),
            "step": first.step == second.step}


def phase_trainer(seed: int) -> dict:
    """The training CLI's path: Trainer.fit, a resume and test()."""
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    cfg = _trainer_config(seed, TRAINER_EPOCHS)
    with contextlib.redirect_stdout(sys.stderr):  # the trainer's own prints
        first = Trainer(cfg, str(TRAINER_DIR))
        eval_batches = TRAINER_EPOCHS * len(first.names) * -(
            -TRAINER_SIZES[1] // int(cfg.test.batch_size))
        steps = TRAINER_EPOCHS * first.steps_per_epoch
        freed = _reset_peak()
        # the main path: fit(), every launch counter read around it
        kernels.reset_launches()
        t0 = time.perf_counter()
        first.fit()
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        writes = {name: dict(v) for name, v in first.writer.stats.items()}
        second = Trainer(_trainer_config(seed, TRAINER_EPOCHS + 1), str(TRAINER_DIR))
        second.maybe_resume()
        resume = _resume_check(first, second)
        best_epoch, history = first.best_epoch, list(first.history)
        del first
        second.fit()
        rows = second.test()
    with open(TRAINER_DIR / "test_results.csv", newline="") as f:
        csv_rows = list(csv.DictReader(f))
    # each train step runs every forward kernel once a block (16 blocks) and
    # every backward kernel at BWD_CALLS; each eval batch the forwards once a block
    expected = {name: (steps + eval_batches) * 16 if name in FORWARD
                else steps * sum(BWD_CALLS) for name in launches}
    rec = {"phase": "trainer", "D": TRAIN_D, "B": TRAIN_B, "img": IMG,
           "dtype": str(cfg.tpu.compute_dtype), "sizes": list(TRAINER_SIZES),
           "steps_per_epoch": second.steps_per_epoch,
           "epochs": [{k: h[k] for k in ("epoch", "steps", "img_per_s", "train_seconds",
                                         "eval_seconds")} for h in history + second.history],
           "fit_seconds": fit_seconds, "best_epoch": best_epoch,
           "checkpoint": {name: writes.get(name) for name in (ckpt.BEST, ckpt.LAST)},
           "resume_bit_equal": resume, "total": csv_rows[-1] if csv_rows else None,
           "peak_mem_bytes": peak, "cublas_workspaces_freed_bytes": freed,
           "launches": launches, "expected": expected}
    emit(rec)
    if not all(resume.values()):
        raise RuntimeError(f"resumed state differs: {resume}")
    if launches != expected or not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"trainer launches {launches}, want {expected}")
    if (not csv_rows or csv_rows[-1]["Name"] != "Total" or len(csv_rows) != 5
            or rows[-1]["Name"] != "Total"
            or not all(np.isfinite(float(r[k])) for r in csv_rows
                       for k in ("loss", "Di_score", "IOU"))):
        raise RuntimeError(f"bad test_results.csv: {csv_rows}")
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    return rec


# ----------------------------------------------------------------- phase 8


def _family_model(row: str, dtype, seed: int):
    name, adapt, decoder, _ = FAMILY[row]
    kw = {"decoder_name": decoder} if decoder else {}
    return build_model(name, img_size=IMG, num_domains=TRAIN_D, adapt_method=adapt,
                       dtype=dtype, device="cuda", seed=seed, **kw)


def _family_step(model, seed: int):
    optimizer, scheduler = build_optimizer(model, TRAIN_N // TRAIN_B, load_config())
    return make_train_step(model, optimizer, scheduler, TRAIN_D, seed=seed,
                           mkd=model.config["name"].startswith("MDViT"),
                           device_augment=False)


def _losses(metrics: dict) -> dict:
    return {k: metrics[k].item() for k in ("loss", "aux_loss", "kt_loss") if k in metrics}


def _split_launches(launches: dict) -> tuple[dict, dict]:
    return ({k: v for k, v in launches.items() if k in FORWARD},
            {k: v for k, v in launches.items() if k in BACKWARD})


def _calibrate_bn(model, x, onehot, passes: int) -> None:
    """Running stats that hold the batch's moments, as a trained model's do:
    ``passes`` train-mode forwards under no_grad (momentum 0.1, so each BN
    settles as its inputs do). At their init (mean 0, var 1) the stats let
    activations grow through the net (logits 1e7–1e8 at 256²), where
    cancellations in BASE_USE's SE gate inputs magnify the kernels'
    last-bit differences (on an H100, 1.76e-4 of a 1.37e8 logit scale)."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _ in range(passes):
            model(x, onehot, train=True, gen=gen)


def family_row(row: str, seed: int, batch_data) -> dict:
    """One ``family`` record: serving forward and train step of ``row``."""
    fwd_pred, bwd_pred = FAMILY[row][3]
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    images, onehot = _requests(BATCH, seed)
    model = _family_model(row, torch.float32, seed)
    x = normalize(images)
    _calibrate_bn(model, x, onehot, FAMILY_BN_PASSES)
    lap("build")
    forward = make_forward(model)
    kernels.reset_launches()
    probs = forward(images, onehot)
    torch.cuda.synchronize()
    serve_fwd, serve_bwd = _split_launches(dict(kernels.LAUNCHES))
    with torch.no_grad():
        logits = split_seg(model(x, onehot)["seg"])[0]
        with plain_versions():
            plain = split_seg(model(x, onehot)["seg"])[0]
    scale = plain.abs().max().item()
    logit_rel = (logits - plain).abs().max().item() / scale
    probs_ok = (tuple(probs.shape) == (BATCH, IMG, IMG)
                and bool(torch.isfinite(probs).all()) and bool(torch.isfinite(logits).all()))
    del logits, plain, probs
    lap("serving_check")

    # one train step through the kernels, every counter read around it, and
    # the same step from the same weights through the plain versions
    plain_model = copy.deepcopy(model)
    step = _family_step(model, seed)
    kernels.reset_launches()
    metrics = step(*batch_data)
    torch.cuda.synchronize()
    step_fwd, step_bwd = _split_launches(dict(kernels.LAUNCHES))
    plain_step = _family_step(plain_model, seed)
    with plain_versions():
        kernels.reset_launches()
        plain_step(*batch_data)
        torch.cuda.synchronize()
        plain_launches = sum(kernels.LAUNCHES.values())
    grad_l2 = _grad_l2_rel(model, plain_model)
    del plain_model, plain_step
    lap("step_check")

    # speed: fp32 on the model above, bf16 on a fresh one of the same seed
    speed, losses = {}, {"float32": _losses(metrics)}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        if dtype == torch.bfloat16:
            model = _family_model(row, dtype, seed)
            step = _family_step(model, seed)
            losses[name] = _losses(step(*batch_data))
        call = lambda: step(*batch_data)
        _reset_peak()
        t = _time_calls(call, TRAIN_D * TRAIN_B, FAMILY_STEPS, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        p = _profile_calls(call, reps=FAMILY_PROFILED, cpu=False)
        speed[name] = {"step_ms_mean": t["latency_ms_mean"], "step_ms_p50": t["latency_ms_p50"],
                       "img_per_s": t["img_per_s"], "device_busy_ms": p["device_busy_ms"],
                       "device_ops_per_step": p["device_ops_per_call"],
                       "idle_share": 1 - p["device_busy_ms"] / t["latency_ms_mean"],
                       "peak_mib": peak / 2 ** 20}
        lap(f"speed_{name}")
    fwd16 = make_forward(model)
    _reset_peak()
    serving = _time_calls(lambda: fwd16(images, onehot), BATCH, iters=5, warmup=2)
    serving_peak = torch.cuda.max_memory_allocated()
    del model, step, fwd16
    torch.cuda.empty_cache()
    lap("serving_bf16")

    finite = all(np.isfinite(v) for d in losses.values() for v in d.values())
    return {"phase": "family", "row": row, "model": FAMILY[row][0],
            "adapt_method": FAMILY[row][1], "decoder_name": FAMILY[row][2],
            "img": IMG, "serving_B": BATCH, "D": TRAIN_D, "B": TRAIN_B,
            "bn_calibration_passes": FAMILY_BN_PASSES,
            "serving_launches": serve_fwd, "serving_backward_launches": serve_bwd,
            "logit_scale": scale, "logit_rel_err": logit_rel, "tol_rel": MODEL_REL_TOL,
            "probs_ok": probs_ok, "step_launches": {**step_fwd, **step_bwd},
            "predicted_step_launches": {"forward": fwd_pred, "backward": bwd_pred},
            "plain_step_launches": plain_launches,
            "grad_l2_rel_err": grad_l2, "grad_l2_tol": GRAD_L2_TOL, "losses": losses,
            "finite": finite, "speed": speed,
            "serving_bf16": {"img_per_s": serving["img_per_s"],
                             "latency_ms_mean": serving["latency_ms_mean"],
                             "peak_mib": serving_peak / 2 ** 20},
            "seconds": seconds}


def phase_family(seed: int) -> list:
    images, masks = _stores(seed)
    batch_data = (images, masks, torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda())
    failures, out = [], []
    for row in FAMILY:
        rec = family_row(row, seed, batch_data)
        emit(rec)
        out.append(rec)
        fwd, bwd = rec["serving_launches"], rec["step_launches"]
        if not (all(fwd[k] > 0 for k in FORWARD) and not any(rec["serving_backward_launches"].values())
                and all(bwd[k] > 0 for k in FORWARD + BACKWARD)
                and rec["plain_step_launches"] == 0 and rec["probs_ok"] and rec["finite"]
                and rec["logit_rel_err"] <= MODEL_REL_TOL
                and rec["grad_l2_rel_err"] <= GRAD_L2_TOL):
            failures.append(row)
    if failures:
        raise RuntimeError(f"family rows failed: {failures}")
    return out


def _family_cli_config(row: str, seed: int):
    name, adapt, decoder, _ = FAMILY[row]
    sizes = {n: list(FAMILY_CLI_SIZES) for n in ("isic2018", "PH2", "DMF", "SKD")}
    return load_config(overrides={
        "seed": seed, "model": name, "model_adapt": {"adapt_method": adapt or False},
        "model_kwargs": {"decoder_name": decoder} if decoder else {},
        "data": {"img_size": IMG, "synthetic": True, "synthetic_sizes": sizes},
        "train": {"num_epochs": 1, "batch_size": TRAIN_B}})


def phase_family_cli(seed: int) -> list:
    """``Trainer.fit`` of one epoch, ``test()``, then ``load_experiment`` and
    ``make_forward`` on ``best.pt``, for each of ``FAMILY_CLI_ROWS``."""
    out = []
    images, onehot = _requests(BATCH, seed)
    for row in FAMILY_CLI_ROWS:
        exp = FAMILY_DIR / row
        shutil.rmtree(exp, ignore_errors=True)
        cfg = _family_cli_config(row, seed)
        with contextlib.redirect_stdout(sys.stderr):  # the trainer's own prints
            tr = Trainer(cfg, str(exp))
            kernels.reset_launches()
            tr.fit()
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            rows = tr.test()
            history = list(tr.history)
            del tr
            model = load_experiment(str(exp), "cuda")
            probs = make_forward(model)(images, onehot)
            torch.cuda.synchronize()
        with open(exp / "test_results.csv", newline="") as f:
            csv_rows = list(csv.DictReader(f))
        rec = {"phase": "family_cli", "row": row, "dtype": str(cfg.tpu.compute_dtype),
               "sizes": list(FAMILY_CLI_SIZES), "img": IMG,
               "epochs": [{k: h[k] for k in ("epoch", "steps", "img_per_s", "train_seconds",
                                             "eval_seconds")} for h in history],
               "total": csv_rows[-1] if csv_rows else None, "launches": launches,
               "predict_probs_ok": (tuple(probs.shape) == (BATCH, IMG, IMG)
                                    and bool(torch.isfinite(probs).all()))}
        emit(rec)
        out.append(rec)
        del model, probs
        torch.cuda.empty_cache()
        shutil.rmtree(exp, ignore_errors=True)
        if (not rec["predict_probs_ok"] or not all(v > 0 for v in launches.values())
                or not csv_rows or csv_rows[-1]["Name"] != "Total" or rows[-1]["Name"] != "Total"
                or not all(np.isfinite(float(csv_rows[-1][k]))
                           for k in ("loss", "Di_score", "IOU"))):
            raise RuntimeError(f"family_cli {row} failed: {rec}")
    return out


# ----------------------------------------------------------------- phase 9


def _export_model(row: str, dtype, seed: int):
    if row == "MDViT":
        return build_mdvit(img_size=IMG, num_domains=TRAIN_D, dtype=dtype, device="cuda",
                           seed=seed)
    return _family_model(row, dtype, seed)


def phase_export(seed: int) -> dict:
    """``export.export_serving`` of each ``EXPORT_ROWS`` model at B=16 in fp32
    and bf16 (random weights from ``--seed``, the family phase's BN
    calibration), saved, loaded and run on the request batch: the artifact's
    MB, export and load seconds, the loaded program's launches (every
    counter, around one call), its bits against the live ``make_forward``
    (must be equal), and both one's serving ms at B=16. Returns the
    launches of the MDViT fp32 program's call."""
    images, onehot = _requests(BATCH, seed)
    x = normalize(images)
    failures, launches_of = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for row, dtype in itertools.product(EXPORT_ROWS, (torch.float32, torch.bfloat16)):
            name = str(dtype).replace("torch.", "")
            model = _export_model(row, dtype, seed)
            _calibrate_bn(model, x, onehot, FAMILY_BN_PASSES)
            path = os.path.join(tmp, f"{row}_{name}.pt2")
            t0 = time.perf_counter()
            torch.export.save(export.export_serving(model, BATCH, IMG, TRAIN_D), path)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            program = export.load(path)
            load_s = time.perf_counter() - t0
            kernels.reset_launches()
            got = export.run(program, images, onehot)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            live = make_forward(model)
            want = live(images, onehot)
            served = _time_calls(lambda: export.run(program, images, onehot), BATCH,
                                 EXPORT_TIMED, warmup=2)
            served_live = _time_calls(lambda: live(images, onehot), BATCH, EXPORT_TIMED,
                                      warmup=2)
            rec = {"phase": "export", "row": row, "dtype": name, "B": BATCH, "img": IMG,
                   "mb": os.path.getsize(path) / 1e6, "export_seconds": export_s,
                   "load_seconds": load_s, "launches": launches,
                   "max_abs_diff": (got.float() - want.float()).abs().max().item(),
                   "bit_equal": bool(torch.equal(got, want)),
                   "probs_ok": (tuple(got.shape) == (BATCH, IMG, IMG)
                                and bool(torch.isfinite(got).all())),
                   "program_ms_mean": served["latency_ms_mean"],
                   "live_ms_mean": served_live["latency_ms_mean"]}
            emit(rec)
            launches_of[(row, name)] = launches
            if not (rec["bit_equal"] and rec["probs_ok"]
                    and launches == {k: 16 if k in FORWARD else 0 for k in launches}):
                failures.append(rec)
            os.remove(path)
            del model, program, live, got, want
            torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"export checks failed: {failures}")
    return launches_of[("MDViT", "float32")]


# ----------------------------------------------------------------- phase 10


def _remat_model(row: str, seed: int):
    if row == "MDViT":
        return build_mdvit(img_size=IMG, num_domains=TRAIN_D, dtype=torch.float32,
                           device="cuda", seed=seed, drop_rate=0.1, drop_path_rate=0.1)
    return _family_model(row, torch.float32, seed)


def _rel_l2(a, b) -> float:
    num = sum(((x - y).double() ** 2).sum().item() for x, y in zip(a, b))
    den = sum((y.double() ** 2).sum().item() for y in b)
    return (num / den) ** 0.5


def remat_row(row: str, seed: int, batch_data) -> dict:
    """One fp32 train step of ``row`` (dropout and stochastic depth 0.1, no
    augmentation) with ``remat`` off and on, and a second plain step (the
    control), from one state: every counter read around each step, the
    losses, BN running stats and generator state (must be equal), the
    relative L2 of the gradients and of the parameter updates against the
    plain step's, the control's too; then step ms, device-busy ms and peak
    memory of each, the peak read over the timed steps after the first
    (AdamW's state made)."""
    model = _remat_model(row, seed)
    mkd = row.startswith("MDViT")
    out = {}
    for name, m in (("plain", copy.deepcopy(model)), ("control", copy.deepcopy(model)),
                    ("remat", model)):
        optimizer, scheduler = build_optimizer(m, TRAIN_N // TRAIN_B, load_config())
        step = make_train_step(m, optimizer, scheduler, TRAIN_D, seed=seed, mkd=mkd,
                               device_augment=False, remat=name == "remat")
        params = list(m.parameters())
        before = [p.detach().clone() for p in params]
        kernels.reset_launches()
        metrics = step(*batch_data)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        res = {"metrics": metrics, "launches": launches,
               "update": [p.detach() - b for p, b in zip(params, before)],
               "grads": [p.grad.detach().clone() for p in params],
               "buffers": [b.clone() for b in m.buffers()],
               "gen": step.generator.get_state()}
        del before
        if name == "control":  # the plain step's run-to-run spread only
            out[name] = res
            continue
        call = lambda: step(*batch_data)
        call()
        _reset_peak()
        resident = torch.cuda.memory_allocated()
        t = _time_calls(call, TRAIN_D * TRAIN_B, REMAT_STEPS, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        p = _profile_calls(call, reps=1, cpu=False)
        res["speed"] = {"step_ms_mean": t["latency_ms_mean"], "step_ms_p50": t["latency_ms_p50"],
                        "device_busy_ms": p["device_busy_ms"],
                        "device_ops_per_step": p["device_ops_per_call"],
                        "idle_share": 1 - p["device_busy_ms"] / t["latency_ms_mean"],
                        "peak_mib": peak / 2 ** 20,
                        "peak_over_resident_mib": (peak - resident) / 2 ** 20}
        out[name] = res
        del m, optimizer, step, call
        torch.cuda.empty_cache()
    plain, remat, control = out["plain"], out["remat"], out["control"]
    fwd_pred, bwd_pred = REMAT[row]
    rec = {"phase": "remat", "row": row, "dtype": "float32", "D": TRAIN_D, "B": TRAIN_B,
           "img": IMG, "drop": 0.1,
           "losses": {k: _losses(r["metrics"]) for k, r in out.items()},
           "losses_equal": all(torch.equal(remat["metrics"][k], v)
                               for k, v in plain["metrics"].items()),
           "bn_stats_bit_equal": all(_same_bits(a, b) for a, b in
                                     zip(remat["buffers"], plain["buffers"])),
           "generator_equal": bool(torch.equal(remat["gen"], plain["gen"])),
           "grad_l2_rel": _rel_l2(remat["grads"], plain["grads"]),
           "update_l2_rel": _rel_l2(remat["update"], plain["update"]),
           "control_grad_l2_rel": _rel_l2(control["grads"], plain["grads"]),
           "control_update_l2_rel": _rel_l2(control["update"], plain["update"]),
           "grad_l2_tol": GRAD_L2_TOL,
           "launches": {k: r["launches"] for k, r in out.items()},
           "predicted_launches": {"forward": fwd_pred, "backward": bwd_pred},
           "speed": {k: out[k]["speed"] for k in ("plain", "remat")}}
    rec["launches_as_predicted"] = (
        remat["launches"] == {k: fwd_pred if k in FORWARD else bwd_pred for k in FORWARD + BACKWARD}
        and plain["launches"] == {k: 16 if k in FORWARD else bwd_pred for k in FORWARD + BACKWARD})
    return rec


def phase_remat(seed: int) -> dict:
    """``remat_row`` for each model of ``REMAT``; fails unless the losses,
    the BN running stats and the generator state are equal, the gradients
    and updates within ``GRAD_L2_TOL``, the control 0 (the step repeats its
    bits, ``device.deterministic``) and the launches as predicted. Returns
    the MDViT remat step's launches."""
    images, masks = _stores(seed)
    batch_data = (images, masks, torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda())
    failures, launches = [], None
    for row in REMAT:
        rec = remat_row(row, seed, batch_data)
        emit(rec)
        if row == "MDViT":
            launches = rec["launches"]["remat"]
        if not (rec["losses_equal"] and rec["bn_stats_bit_equal"] and rec["generator_equal"]
                and rec["grad_l2_rel"] <= GRAD_L2_TOL
                and rec["update_l2_rel"] <= GRAD_L2_TOL
                and rec["control_grad_l2_rel"] == 0.0 and rec["control_update_l2_rel"] == 0.0
                and rec["launches_as_predicted"]):
            failures.append(row)
    if failures:
        raise RuntimeError(f"remat rows failed: {failures}")
    return launches


# ----------------------------------------------------------------- phase 11


def phase_kfold_cli(seed: int) -> dict:
    """The k-fold tools on the card: folds 0 and 1 through the training CLI
    (``cli.main``), ``kfold_aggregate`` over both, ``summarize_run`` of fold
    0, and the export CLI (``export.main --check``: the loaded program
    bit-equal to the live forward) on fold 0's ``best.pt``."""
    shutil.rmtree(KFOLD_DIR, ignore_errors=True)
    KFOLD_DIR.mkdir(parents=True)
    cfg = KFOLD_DIR / "card.yml"
    cfg.write_text(json.dumps({"seed": seed, **KFOLD_CONFIG}))
    exp_dirs = [str(KFOLD_DIR / f"fold{fold}") for fold in "01"]
    out = KFOLD_DIR / "model.pt2"
    with contextlib.redirect_stdout(sys.stderr):  # the CLIs' own prints
        for fold, exp in enumerate(exp_dirs):
            cli.main(["--exp_name", f"kf{fold}", "--model", "MDViT", "--config_yml", str(cfg),
                      "--k_fold", str(fold), "--exp_dir", exp])
        columns = kfold_aggregate.aggregate(exp_dirs)
        summary = summarize_run.summarize(exp_dirs[0])
        t0 = time.perf_counter()
        export.main(["--ckpt_dir", exp_dirs[0], "--out", str(out), "--batch_size", "4",
                     "--check"])
        export_s = time.perf_counter() - t0
    rec = {"phase": "kfold_cli", "img": KFOLD_IMG, "k_fold": columns,
           "summary_epochs_run": summary["epochs_run"], "best_epoch": summary["best_epoch"],
           "export_cli_seconds": export_s, "export_mb": out.stat().st_size / 1e6}
    emit(rec)
    shutil.rmtree(KFOLD_DIR, ignore_errors=True)
    values = [v for k, col in columns.items() if k != "Name" for v in col]
    if (columns["Name"] != ["isic2018", "PH2", "Total"] or not all(np.isfinite(values))
            or summary["epochs_run"] != 1):
        raise RuntimeError(f"k-fold tools on the card failed: {rec}")
    return rec


# ----------------------------------------------------------------- phase 12


@contextlib.contextmanager
def _nondeterministic():
    """PyTorch's defaults (nondeterministic algorithms allowed, cuDNN's
    nondeterministic algorithms, no autotuning), for a step built while it
    stands in for ``device.deterministic``."""
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[1:]


def _control_model(row: str, dtype, seed: int):
    if row == "MDViT":
        return build_mdvit(img_size=IMG, num_domains=TRAIN_D, dtype=dtype, device="cuda",
                           seed=seed, drop_rate=0.1, drop_path_rate=0.1)
    return _family_model(row, dtype, seed)


def _control_step(model, seed: int, determinism: bool):
    """The model's own train step with augmentation (AdamW, the default
    config), built with ``device.deterministic`` or PyTorch's defaults."""
    optimizer, scheduler = build_optimizer(model, TRAIN_N // TRAIN_B, load_config())
    with contextlib.nullcontext() if determinism else mock.patch.object(
            steps_module, "deterministic", _nondeterministic):
        return make_train_step(model, optimizer, scheduler, TRAIN_D, seed=seed,
                               mkd=model.config["name"].startswith("MDViT"))


def _step_result(model, step, batch_data) -> dict:
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    metrics = step(*batch_data)
    torch.cuda.synchronize()
    return {"metrics": metrics, "grads": [p.grad.detach().clone() for p in params],
            "update": [p.detach() - b for p, b in zip(params, before)],
            "buffers": [b.clone() for b in model.buffers()]}


def control_row(row: str, dtype, seed: int, batch_data) -> dict:
    """Two steps from one state, with the setting on and off: the gap
    between the two (relative L2 of gradients and updates; whether losses
    and BN stats are bit-equal); for the flagship (``DETERMINISM_COST_ROW``)
    then the two settings' steps, each on its second step's model, timed in
    alternating pairs (step ms, and the median of the pairs' differences)
    and profiled (device-busy ms)."""
    model = _control_model(row, dtype, seed)
    rec = {"phase": "determinism", "row": row, "dtype": str(dtype).replace("torch.", ""),
           "D": TRAIN_D, "B": TRAIN_B, "img": IMG, "augment": True, "drop": 0.1}
    calls = {}
    for key in ("on", "off"):
        runs = []
        for _ in range(2):
            m = copy.deepcopy(model)
            step = _control_step(m, seed, key == "on")
            runs.append(_step_result(m, step, batch_data))
        a, b = runs
        rec[key] = {
            "grad_l2_rel": _rel_l2(a["grads"], b["grads"]),
            "update_l2_rel": _rel_l2(a["update"], b["update"]),
            "losses_bit_equal": all(_same_bits(v, b["metrics"][k])
                                    for k, v in a["metrics"].items()),
            "bn_stats_bit_equal": all(_same_bits(x, y)
                                      for x, y in zip(a["buffers"], b["buffers"])),
            "losses": _losses(a["metrics"])}
        del runs, a, b
        if row == DETERMINISM_COST_ROW:
            calls[key] = (m, functools.partial(step, *batch_data))
        del m, step
    if calls:
        t_on, t_off, extra = _time_pairs(calls["on"][1], calls["off"][1], TRAIN_D * TRAIN_B,
                                         DETERMINISM_PAIRS)
        for key, t in (("on", t_on), ("off", t_off)):
            p = _profile_calls(calls[key][1], reps=1, cpu=False)
            rec[key].update(step_ms=t["latency_ms_mean"], step_ms_p50=t["latency_ms_p50"],
                            device_busy_ms=p["device_busy_ms"],
                            device_ops_per_step=p["device_ops_per_call"], top=p["top"])
        rec["step_ms_on_minus_off_median"] = extra
        rec["busy_cost_share"] = rec["on"]["device_busy_ms"] / rec["off"]["device_busy_ms"] - 1
    del calls
    torch.cuda.empty_cache()
    return rec


def _interpolate_backward_probe() -> dict:
    """``F.interpolate``'s bilinear backward, the op the separable resize
    replaced, at the logits' 64² → 256² (C = 1) and the MLPFM debranch's
    8² → 64² (C = 512), B = 16: whether it raises under
    ``device.deterministic`` (the error's first line), and whether two
    backwards give the same bits with the setting and with PyTorch's
    defaults."""
    out = {}
    for c, src, dst in ((1, 64, 256), (512, 8, 64)):
        gen = torch.Generator().manual_seed(c)
        x = torch.randn(TRAIN_D * TRAIN_B, c, src, src, generator=gen).cuda().requires_grad_()
        g = torch.randn(TRAIN_D * TRAIN_B, c, dst, dst, generator=gen).cuda()

        def grad():
            y = F.interpolate(x, size=(dst, dst), mode="bilinear", align_corners=False)
            return torch.autograd.grad(y, x, g)[0]

        rec = {"raises_under_determinism": None}
        with _nondeterministic():
            a, b = grad(), grad()
        rec["repeats_by_default"] = _same_bits(a, b)
        with deterministic():
            try:
                a, b = grad(), grad()
                rec["repeats_under_determinism"] = _same_bits(a, b)
            except RuntimeError as exc:  # the finding recorded: the op refuses
                rec["raises_under_determinism"] = str(exc).splitlines()[0][:300]
        out[f"{src}->{dst} C={c}"] = rec
    return out


def phase_determinism(seed: int) -> list:
    """The train step repeats its bits (ROADMAP C.1): ``control_row`` for
    MDViT and BASE in fp32 and bf16, which must read 0 with the setting on;
    the separable resize against ``F.interpolate``'s forward at 256²; and
    whether ``F.interpolate``'s backward runs under the setting."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(TRAIN_D * TRAIN_B, IMG // 4, IMG // 4, 1, generator=gen).cuda()
    got = resize_bilinear(x, (IMG, IMG))
    want = F.interpolate(x.permute(0, 3, 1, 2), size=(IMG, IMG), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    resize = {"phase": "determinism_resize", "shape": list(x.shape), "to": [IMG, IMG],
              "max_rel_err": (got - want).abs().max().item() / want.abs().max().item(),
              "tol_rel": RESIZE_REL_TOL,
              "interpolate_backward": _interpolate_backward_probe()}
    emit(resize)
    images, masks = _stores(seed)
    batch_data = (images, masks, torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda())
    recs, failures = [], []
    for row in DETERMINISM_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            rec = control_row(row, dtype, seed, batch_data)
            emit(rec)
            recs.append(rec)
            on = rec["on"]
            if not (on["grad_l2_rel"] == 0.0 and on["update_l2_rel"] == 0.0
                    and on["losses_bit_equal"] and on["bn_stats_bit_equal"]):
                failures.append((row, rec["dtype"]))
    if failures or not resize["max_rel_err"] <= RESIZE_REL_TOL:
        raise RuntimeError(f"determinism failed: {failures}, resize {resize['max_rel_err']}")
    return recs


# ----------------------------------------------------------------- phase 13


def _dp_model(seed: int):
    return build_mdvit(img_size=IMG, num_domains=TRAIN_D, dtype=torch.float32, device="cuda",
                       seed=seed, drop_rate=0.1, drop_path_rate=0.1)


def _dp_run(seed: int, group) -> dict:
    """One flagship step (augmentation on, SGD) of a fresh seeded model in
    ``group`` (None: one process): launches, metrics, BN stats, gradients
    and updates on the host; then ``DP_TIMED`` more steps timed."""
    model = _dp_model(seed)
    optimizer = torch.optim.SGD(model.parameters(), lr=DP_LR)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda _: 1.0)
    step = make_train_step(model, optimizer, scheduler, TRAIN_D, seed=seed, group=group)
    images, masks = _stores(seed)
    batch = (images, masks, torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda())
    kernels.reset_launches()
    res = _step_result(model, step, batch)
    res["launches"] = dict(kernels.LAUNCHES)
    res = ckpt.to_host(res)
    lat = []
    for _ in range(DP_TIMED):
        if group is not None:
            torch.distributed.barrier(group=group)
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"] = lat
    return res


def _dp_rank(rank: int, seed: int, store: str, out: str, world: int, backend: str) -> None:
    """A rank of the dp phase's group: ``_dp_run`` of its rows, saved to
    ``out/rank<r>.pt``; gloo ranks share card 0, an NCCL rank takes card r."""
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.distributed.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                         world_size=world)
    try:
        with no_tf32():
            res = _dp_run(seed, torch.distributed.group.WORLD)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item() / max(b.abs().max().item(), 1e-30)


def phase_dp(seed: int, world: int = DP_WORLD, backend: str = "gloo") -> dict:
    """Data parallelism on the card: (1) an NCCL group of one against no
    group (bit-equal losses, BN stats, gradients and updates); (2) ``world``
    ranks spawned (gloo: all on card 0; NCCL, with ``--dp-cards``: one a
    card) against one process: the loss and the BN running stats within
    ``DP_REL_TOL``, gradients and updates within ``GRAD_L2_TOL``, the
    replicas bit-equal, 16 / 31 launches a rank; (3) the step ms of both,
    recorded. Returns rank 0's launches."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    single = _dp_run(seed, None)
    torch.distributed.init_process_group("nccl", init_method=f"file://{DP_DIR / 'nccl'}",
                                         rank=0, world_size=1)
    try:
        one = _dp_run(seed, torch.distributed.group.WORLD)
    finally:
        torch.distributed.destroy_process_group()
    same = lambda a, b: all(_same_bits(x, y) for x, y in zip(a, b))  # noqa: E731
    group_of_one = {
        "losses_bit_equal": same(one["metrics"].values(), single["metrics"].values()),
        "bn_stats_bit_equal": same(one["buffers"], single["buffers"]),
        "grads_bit_equal": same(one["grads"], single["grads"]),
        "updates_bit_equal": same(one["update"], single["update"]),
        "launches": one["launches"]}
    torch.multiprocessing.start_processes(
        _dp_rank, args=(seed, str(DP_DIR / backend), str(DP_DIR), world, backend),
        nprocs=world, join=True, start_method="spawn")
    ranks = [torch.load(DP_DIR / f"rank{r}.pt", weights_only=False) for r in range(world)]
    r0 = ranks[0]
    expected = {k: 16 if k in FORWARD else 31 for k in FORWARD + BACKWARD}
    rec = {"phase": "dp", "world": world, "backend": backend, "D": TRAIN_D, "B": TRAIN_B,
           "img": IMG, "rows_per_rank": TRAIN_D * TRAIN_B // world, "optimizer": "sgd",
           "augment": True, "drop": 0.1, "group_of_one_nccl": group_of_one,
           "loss_rel_err": max(_rel_max(r0["metrics"][k], single["metrics"][k])
                               for k in ("loss", "aux_loss", "kt_loss")),
           "bn_stats_rel_err": max(_rel_max(a, b) for a, b in
                                   zip(r0["buffers"], single["buffers"])
                                   if a.is_floating_point()),
           "grad_l2_rel": _rel_l2(r0["grads"], single["grads"]),
           "update_l2_rel": _rel_l2(r0["update"], single["update"]),
           "replicas_bit_equal": all(same(r["update"], r0["update"]) for r in ranks[1:]),
           "launches_per_rank": [r["launches"] for r in ranks], "expected_launches": expected,
           "step_ms": {"one_process": single["step_ms"],
                       **{f"rank{i}": r["step_ms"] for i, r in enumerate(ranks)}},
           "tol": {"rel": DP_REL_TOL, "grad_l2": GRAD_L2_TOL}}
    emit(rec)
    shutil.rmtree(DP_DIR, ignore_errors=True)
    if not (all(group_of_one[k] for k in ("losses_bit_equal", "bn_stats_bit_equal",
                                          "grads_bit_equal", "updates_bit_equal"))
            and group_of_one["launches"] == expected and single["launches"] == expected
            and rec["loss_rel_err"] <= DP_REL_TOL and rec["bn_stats_rel_err"] <= DP_REL_TOL
            and rec["grad_l2_rel"] <= GRAD_L2_TOL and rec["update_l2_rel"] <= GRAD_L2_TOL
            and rec["replicas_bit_equal"]
            and all(r["launches"] == expected for r in ranks)):
        raise RuntimeError(f"dp phase failed: {json.dumps(rec)[:2000]}")
    return r0["launches"]


# ----------------------------------------------------------------- zoo


def _zoo_model(name: str, dtype, seed: int, device: str = "cuda"):
    return build_model(name, img_size=IMG, num_domains=TRAIN_D, dtype=dtype, device=device,
                       seed=seed)


def _maps(out: dict) -> list:
    """Every map a model returns (TransFuse: map_x, map_1, map_2)."""
    seg = out["seg"]
    return list(seg) if isinstance(seg, tuple) else [seg]


def _add_launches(total: dict) -> None:
    for k, v in kernels.LAUNCHES.items():
        total[k] = total.get(k, 0) + v


def _zoo_train(name: str, dtype, seed: int, batch_data, launches: dict) -> dict:
    """Two steps from one state with the counters read around each (the
    control: bit-equal), then the step timed and profiled, and its peak."""
    model = _zoo_model(name, dtype, seed)
    runs = []
    for _ in range(2):
        m = copy.deepcopy(model)
        step = _family_step(m, seed)
        kernels.reset_launches()
        runs.append(_step_result(m, step, batch_data))
        _add_launches(launches)
    a, b = runs
    control = {"losses_bit_equal": all(_same_bits(v, b["metrics"][k])
                                       for k, v in a["metrics"].items()),
               "grads_bit_equal": all(_same_bits(x, y) for x, y in zip(a["grads"], b["grads"])),
               "bn_stats_bit_equal": all(_same_bits(x, y)
                                         for x, y in zip(a["buffers"], b["buffers"]))}
    losses = _losses(a["metrics"])
    del runs, a, b
    call = functools.partial(step, *batch_data)
    kernels.reset_launches()
    _reset_peak()
    t = _time_calls(call, TRAIN_D * TRAIN_B, ZOO_STEPS, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    p = _profile_calls(call, reps=1, cpu=False)
    _add_launches(launches)
    del model, m, step, call
    torch.cuda.empty_cache()
    return {"losses": losses, "finite": all(np.isfinite(v) for v in losses.values()),
            "control": control, "step_ms_mean": t["latency_ms_mean"],
            "step_ms_p50": t["latency_ms_p50"], "img_per_s": t["img_per_s"],
            "device_busy_ms": p["device_busy_ms"], "device_ops_per_step": p["device_ops_per_call"],
            "idle_share": 1 - p["device_busy_ms"] / t["latency_ms_mean"],
            "peak_mib": peak / 2 ** 20, "top": p["top"][:3]}


def zoo_row(name: str, seed: int, batch_data, launches: dict) -> dict:
    """One ``zoo`` record: the serving forward (fp32, B=16, mixed one-hots)
    with the counters read around it, its logits against the host CPU's at
    B=2, and one train step in fp32 and bf16 (``_zoo_train``)."""
    t0 = time.perf_counter()
    images, onehot = _requests(BATCH, seed)
    model = _zoo_model(name, torch.float32, seed)
    # at their init the BN running stats let UTNet's activations reach ~1e6,
    # where its attention's softmax picks by last bits and the card and the
    # CPU disagree by the logits' whole scale: the family's calibration,
    # then the CPU model takes these stats
    _calibrate_bn(model, normalize(images), onehot, FAMILY_BN_PASSES)
    forward = make_forward(model)
    kernels.reset_launches()
    probs = forward(images, onehot)
    torch.cuda.synchronize()
    serve = dict(kernels.LAUNCHES)
    _add_launches(launches)
    probs_ok = (tuple(probs.shape) == (BATCH, IMG, IMG) and bool(torch.isfinite(probs).all()))
    serving = _time_calls(lambda: forward(images, onehot), BATCH, iters=5, warmup=2)
    x, oh = normalize(images[:ZOO_CPU_B]), onehot[:ZOO_CPU_B]
    with torch.no_grad(), deterministic():
        card = [m.float().cpu() for m in _maps(model(x, oh))]
        host_model = _zoo_model(name, torch.float32, seed, "cpu")
        host_model.load_state_dict(model.state_dict())
        host = _maps(host_model(x.cpu(), oh.cpu()))
    scale = max(1.0, max(h.abs().max().item() for h in host))
    err = max((c - h).abs().max().item() for c, h in zip(card, host))
    finite, n_maps = all(bool(torch.isfinite(c).all()) for c in card), len(card)
    del model, forward, probs, card, host, host_model
    torch.cuda.empty_cache()
    train = {d: _zoo_train(name, dt, seed, batch_data, launches)
             for d, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
    return {"phase": "zoo", "model": name, "img": IMG, "serving_B": BATCH, "D": TRAIN_D,
            "B": TRAIN_B, "bn_calibration_passes": FAMILY_BN_PASSES,
            "serving_launches": serve, "probs_ok": probs_ok,
            "serving_fp32": {"latency_ms_mean": serving["latency_ms_mean"],
                             "img_per_s": serving["img_per_s"]},
            "cpu_B": ZOO_CPU_B, "maps": n_maps,
            "card_vs_cpu_max_abs_err": err, "logit_scale": scale,
            "tol": ZOO_LOGIT_TOL * scale, "logits_finite": finite, "train": train,
            "seconds": time.perf_counter() - t0}


def _backbone_checkpoints(folder: Path, seed: int) -> dict:
    """Random torchvision resnet34 and timm deit_small state dicts (the
    layouts the converter reads: torchvision's ``layer1.0`` and
    ``downsample``, timm's ``blocks.i`` with the cls token, a 14×14 + 1
    position embedding and the head), saved as .pth files."""
    from mdvit_tpu_torch.models.transfuse import DeiT, ResNetStem3Stages
    from mdvit_tpu_torch.ops.initializers import init_weights_

    gen = torch.Generator().manual_seed(seed)
    resnet = ResNetStem3Stages("resnet34")
    init_weights_(resnet, gen)
    tv = {}
    for k, v in resnet.state_dict().items():
        k = k.replace("down_conv", "downsample.0").replace("down_bn", "downsample.1")
        head, _, rest = k.partition(".")
        if head.startswith("layer"):
            head = head.replace("_", ".")
        tv[f"{head}.{rest}"] = v
    deit = DeiT(224, embed_dim=384, depth=12, num_heads=6)
    init_weights_(deit, gen)
    timm = {"cls_token": 0.02 * torch.randn(1, 1, 384, generator=gen),
            "pos_embed": 0.02 * torch.randn(1, 197, 384, generator=gen),
            "head.weight": 0.02 * torch.randn(1000, 384, generator=gen),
            "head.bias": torch.zeros(1000)}
    for k, v in deit.state_dict().items():
        if k == "pos_embed":
            continue
        if k.startswith("block"):
            i, _, rest = k[len("block"):].partition("_")
            k = f"blocks.{i}.{rest}"
        timm[k.replace("patch_embed.", "patch_embed.proj.")] = v
    paths = {"resnet34": folder / "resnet34.pth", "deit_small": folder / "deit_small.pth"}
    torch.save(tv, paths["resnet34"])
    torch.save({"model": timm}, paths["deit_small"])
    return paths


def _zoo_cli(seed: int, launches: dict) -> dict:
    """``Trainer.fit`` of one epoch of TransFuse_S (bf16, synthetic data)
    from backbones converted by ``convert_torch_weights``, then ``test()``."""
    from mdvit_tpu_torch import convert_torch_weights

    ckpts = _backbone_checkpoints(ZOO_DIR, seed)
    pre = ZOO_DIR / "pretrained"
    for arch, path in ckpts.items():
        convert_torch_weights.main(["--arch", arch, "--ckpt", str(path), "--grid", "16",
                                    "--out_dir", str(pre)])
    sizes = {n: list(ZOO_CLI_SIZES) for n in ("isic2018", "PH2", "DMF", "SKD")}
    cfg = load_config(overrides={
        "seed": seed, "model": "TransFuse_S", "pretrained_folder": str(pre),
        "data": {"img_size": IMG, "synthetic": True, "synthetic_sizes": sizes},
        "train": {"num_epochs": 1, "batch_size": TRAIN_B}})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tr = Trainer(cfg, str(ZOO_DIR / "exp"))
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr.fit()
        rows = tr.test()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _add_launches(launches)
        history = list(tr.history)
        del tr
    text = out.getvalue()
    print(text, file=sys.stderr, end="")
    report = next((line for line in text.splitlines() if "tensors grafted" in line), None)
    return {"model": "TransFuse_S", "dtype": str(cfg.tpu.compute_dtype),
            "sizes": list(ZOO_CLI_SIZES), "graft_report": report,
            "epochs": [{k: h[k] for k in ("epoch", "steps", "img_per_s", "train_seconds",
                                          "eval_seconds")} for h in history],
            "total": rows[-1], "fit_and_test_seconds": seconds}


def _zoo_features(seed: int) -> dict:
    """``extract_features`` of the full-width MDViT (weights from ``seed``)
    on the card and on the host CPU: the features' max abs difference over
    their scale, ids and domain ids equal, and the card's launches."""
    from mdvit_tpu_torch import extract_features

    outs, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            extract_features.main(["--model", "MDViT", "--synthetic", "--dataset",
                                   *ZOO_FEATURE_SETS, "--img_size", str(IMG),
                                   "--batch_size", str(BATCH), "--seed", str(seed),
                                   "--device", dev, "--out", str(ZOO_DIR / f"features_{dev}")])
        seconds[dev] = time.perf_counter() - t0
        if dev == "cuda":
            card_launches = dict(kernels.LAUNCHES)
        outs[dev] = {n: dict(np.load(ZOO_DIR / f"features_{dev}" / f"features_{n}.npz"))
                     for n in ZOO_FEATURE_SETS}
    rel = max(np.abs(outs["cuda"][n]["features"] - outs["cpu"][n]["features"]).max()
              / np.abs(outs["cpu"][n]["features"]).max() for n in ZOO_FEATURE_SETS)
    same = all(np.array_equal(outs["cuda"][n][k], outs["cpu"][n][k])
               for n in ZOO_FEATURE_SETS for k in ("ids", "domain_id", "diagnosis_id"))
    return {"datasets": list(ZOO_FEATURE_SETS),
            "shapes": {n: list(outs["cuda"][n]["features"].shape) for n in ZOO_FEATURE_SETS},
            "max_rel_err": float(rel), "tol_rel": ZOO_FEATURE_TOL, "ids_equal": same,
            "card_launches": card_launches, "seconds": seconds}


def phase_zoo(seed: int) -> dict:
    """The paper's segmentation comparators on the card: ``zoo_row`` for each
    of ``ZOO``; TransFuse_L_384's forward at 384×512; one CLI epoch of
    TransFuse_S from converted backbones; ``extract_features`` card against
    CPU. Every launch counter is read around the comparators' calls and must
    read 0. Returns those launches."""
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    ZOO_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    images, masks = _stores(seed)
    batch_data = (images, masks, torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda())
    launches: dict = {}
    failures = []
    for name in ZOO:
        rec = zoo_row(name, seed, batch_data, launches)
        emit(rec)
        ok = (rec["probs_ok"] and rec["logits_finite"] and not any(rec["serving_launches"].values())
              and rec["card_vs_cpu_max_abs_err"] <= rec["tol"]
              and all(t["finite"] and all(t["control"].values()) for t in rec["train"].values()))
        if not ok:
            failures.append(name)
    del batch_data, images, masks
    model = build_model("TransFuse_L_384", num_domains=TRAIN_D, device="cuda", seed=seed)
    gen = torch.Generator().manual_seed(seed + 3)
    x = torch.randint(0, 256, (ZOO_L384_B, 384, 512, 3), generator=gen).float().cuda()
    oh = torch.eye(TRAIN_D)[:ZOO_L384_B].cuda()
    kernels.reset_launches()
    with torch.no_grad(), deterministic():
        maps = _maps(model(normalize(x), oh))
    torch.cuda.synchronize()
    _add_launches(launches)
    l384 = {"model": "TransFuse_L_384", "B": ZOO_L384_B,
            "shapes": [list(m.shape) for m in maps],
            "finite": all(bool(torch.isfinite(m).all()) for m in maps)}
    del model, maps, x
    torch.cuda.empty_cache()
    cli_rec = _zoo_cli(seed, launches)
    features = _zoo_features(seed)
    rec = {"phase": "zoo_more", "transfuse_l_384": l384, "cli": cli_rec,
           "extract_features": features, "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    if not (l384["finite"] and l384["shapes"] == [[ZOO_L384_B, 384, 512, 1]] * 3):
        failures.append("TransFuse_L_384")
    report = cli_rec["graft_report"] or ""
    if not ("tensors grafted, 0 skipped" in report and cli_rec["total"]["Name"] == "Total"
            and all(np.isfinite(cli_rec["total"][k]) for k in ("loss", "Di_score", "IOU"))):
        failures.append("cli")
    if not (features["max_rel_err"] <= ZOO_FEATURE_TOL and features["ids_equal"]
            and all(v > 0 for k, v in features["card_launches"].items() if k in FORWARD)):
        failures.append("extract_features")
    if any(launches.values()):
        failures.append(f"launches {launches}")
    if failures:
        raise RuntimeError(f"zoo phase failed: {failures}")
    return {k: launches.get(k, 0) for k in FORWARD + BACKWARD}


# ----------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp-cards", action="store_true",
                    help="only the build and the dp phase, its ranks NCCL, one a visible "
                    "card (a host of several cards)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        emit({"phase": "seconds", "of": name, "seconds": seconds[name]})
        return out

    timed("build", phase_build)
    if args.dp_cards:
        with no_tf32():
            timed("dp", phase_dp, args.seed, torch.cuda.device_count(), "nccl")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    with no_tf32():
        summary = timed("kernels", phase_kernels, args.seed)
        summary.update(timed("backward", phase_backward, args.seed))
        timed("split", phase_split, args.seed)
        serving_launches = timed("model", phase_model, args.seed)
        augment = timed("augment", phase_augment, args.seed)
        step_launches = timed("train", phase_train, args.seed, augment)
        trainer = timed("trainer", phase_trainer, args.seed)
        timed("family", phase_family, args.seed)
        timed("family_cli", phase_family_cli, args.seed)
        export_launches = timed("export", phase_export, args.seed)
        remat_launches = timed("remat", phase_remat, args.seed)
        timed("kfold_cli", phase_kfold_cli, args.seed)
        timed("determinism", phase_determinism, args.seed)
        dp_launches = timed("dp", phase_dp, args.seed)
        zoo_launches = timed("zoo", phase_zoo, args.seed)
    paths = {"serving B=16 fp32": serving_launches, "train step fp32": step_launches,
             "Trainer.fit": trainer["launches"], "exported program B=16 fp32": export_launches,
             "remat train step fp32": remat_launches,
             f"dp train step fp32, rank 0 of {DP_WORLD}": dp_launches, "zoo": zoo_launches}
    line = []
    for name in REPLACES:
        s = summary[name]
        calls = sum(FWD_CALLS if name in FORWARD else BWD_CALLS)
        line.append({"name": name, "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name], "launches": trainer["launches"][name],
                     "max_abs_err": s["max_abs_err"], **s["float32"],
                     "bound_by": "bytes" if s["bound_by"] == {"bytes"} else "operations",
                     "per": f"one fp32 train step, D*B=16 at 256 ({calls} calls)",
                     "launches_per": "Trainer.fit, 2 epochs of 8 steps and 8 eval "
                                     "batches, bf16, D*B=16 at 256",
                     "launches_by_path": {path: n[name] for path, n in paths.items()},
                     "bf16": s["bfloat16"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0, "by_phase": seconds})
    print(smi, flush=True)
    emit({"kernels": line})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
