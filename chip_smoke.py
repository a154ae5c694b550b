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
            sums); then (``kernel_classifier`` records) A at every (N, C, ch)
            the ten classifiers send at 224² and B, C on CoaT's views (the
            image rows of (B, H·W + 1, ·) tokens) at C = 152 and 216, B=16,
            fp32 and bf16: the check, bit-equal on a second call, device ms
            (plain ms in fp32) beside the bound;
3. backward each backward op (``torch.ops.mdvit.*_bwd``) against its plain
            backward at the same shapes and types, two calls bit-equal,
            and the same times; the
            library yardstick of CPE/CRPE is cuDNN's backward of their
            ``F.conv2d(groups=C)`` forms (``aten.convolution_backward``);
            A′, B′, C′ at the classifiers' shapes as A, B, C in phase 2;
   dropout  kernel D (``mdvit::dropout``) at every call of phase 6's fp32
            train step (shapes and counter layouts read from one step) and
            at the benchmark step's two largest shapes, fp32 and bf16:
            bit-equal to the torch formula on the card, device ms of both
            beside the bound;
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
15. classifiers  the ten MPViT and CoaT classifiers at their published
            widths, 224², B=16, random weights from ``--seed`` (MPViT's BN
            calibrated as the family's), one ``classifier`` line each: the
            fp32 forward with every launch counter read around it (A, B, C
            once a block, ``CLASSIFIERS``), its logits and feat against the
            plain versions (within 1e-4·max(1, max|logit|)); one
            cross-entropy backward pull in fp32 with the counters read
            around it (A′, B′, C′ once a block), its gradients against the
            plain backward (relative L2); the bf16 forward (finite, and
            against its plain versions); forward img/s, device-busy ms,
            idle share and peak in fp32 and bf16; A's and A′'s device ms a
            call summed from the ``kernel_classifier`` records;
16. cp       context parallelism: A and A′ on the row halves of the four
            stage shapes (B=16) and of BASE's four grids at 512² (B=2, the
            shapes a rank of the 2-rank step sends them), fp32 and bf16
            (each half's partials, the workspaces concatenated in rank order
            as the all-gather gives them, each half's apply) against the
            single call and the plain split, B–C′ on halo'd row halves
            against the full grid and the plain versions, device ms of one
            half's A and A′ beside the single call's and the bytes a rank
            gathers; an NCCL ctx
            group of one against no group (the stage forward bit-equal, the
            BASE forward); then two gloo ranks on the one card against one
            process: MDViT's stage 0 at full width (forward, gradients) and
            BASE at full width at 512², B=2 (fp32 and bf16 forwards, one
            fp32 CP train step: loss, BN stats, gradients, launches a rank),
            step ms, device-busy ms and peak MiB a rank. Then ragged row
            blocks (H no multiple of 32, every grid split by
            ``row_split``): A and A′ on BASE's 470² stage grids (118 rows
            split 56 : 62 .. 15 rows 7 : 8), on its 452² grids over four
            ranks (the deepest 4 : 4 : 4 : 3) and on ``coat_small``'s four
            scales at 230² (57 rows 32 : 25 .. 7 rows 4 : 3) with the cls
            row on rank 0 (each rank's workspace padded to the most chunks
            with empty partials: the padded fold bit-equal to the unpadded
            one; against the single call and the plain split), B–C′ on
            BASE's halo'd ragged blocks against the full grid and the plain
            versions, each kernel's ms a rank beside its bound, and one more
            two-rank spawn: BASE at 470² as at 512², ``mpvit_base`` and
            ``coat_small`` at 230², B=16 (eval forward and a cross-entropy
            pull: logits, summed gradients, launches once a block), MDViT
            with the DeepLabV3 debranch at 512² (eval forward); each record
            with every grid's rows a rank. Then the
            segmentation comparators in one more two-rank spawn at their
            published widths, fp32, B=2: UTNet, SwinUnet, SwinUNETR and
            TransFuse_S at 512², TransFuse_L_384 at 384×512 (``CP_ZOO``):
            the train-mode forward (running stats frozen) against one
            process, every map and feat; for UTNet, SwinUnet and SwinUNETR
            one CP train step (loss and BN stats; the gradients of the same
            step in fp64, ranks against one process within
            ``CP_FP64_GRAD_TOL``, the fp32 gradients' gaps recorded); every
            launch counter 0; a rank's step ms, busy ms and peak MiB (TransFuse:
            the forward's ms and peak) beside one process's;
17. the ``kernels`` line (launches from the trainer's ``fit``, and by path
   under ``launches_by_path``, ``zoo`` and the comparators' CP path all
   0), the card's name and power limit, and last the ``{"ok": true,
   "device": ...}`` line. Each phase prints its seconds.

``--dp-cards`` runs only the build, the dp phase with one NCCL rank on each
visible card (a host of several cards) in place of the gloo ranks, and the
cp phase's ranks: ctx over every card at 512², B=2, and on four cards ctx
at 452² (deepest rows 4, 4, 4, 3; input rows 128, 128, 128, 68), the (2, 2)
data × ctx grid at B=4 and
SwinUnet with ctx = 4 at 512² (its windows span two ranks; the shift wraps
from the last rank to the first), each against one process. ``--cp-only`` runs
only the build and the cp phase; with ``--dp-cards``, only the build and the
cp phase's NCCL ranks.

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
import math
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
from mdvit_tpu_torch.models import coat, mpvit
from mdvit_tpu_torch.models.base import FATEncoderDecoder, split_seg
from mdvit_tpu_torch.models.blocks import MHSAStage
from mdvit_tpu_torch.models.registry import build_mdvit, build_model
from mdvit_tpu_torch.ops import dwconv, kernels, layers
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import fast_normal, fast_uniform
from mdvit_tpu_torch.ops.norm import DomainBatchNorm, running_stats_frozen
from mdvit_tpu_torch.ops import resize as resize_module
from mdvit_tpu_torch.ops.resize import resize_bilinear
from mdvit_tpu_torch.parallel.context import (ContextMesh, make_context_parallel_train_step,
                                              make_dp_context_mesh, model_apply_context_parallel,
                                              stage_apply_context_parallel)
from mdvit_tpu_torch.parallel.mesh import balanced_rows, row_split
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
# kernel D (``mdvit::dropout``) in that step, dropout and stochastic depth
# 0.1: 84 calls in the forward and 168 in the backwards of its two pulls
DROPOUT_CALLS = (84, 168)
# D's two largest calls in the benchmark's 64-image step, as (images,
# tokens, channels): the MLP's hidden layer at stages 0 and 1
DROPOUT_SHAPES = ((64, 4096, 512), (64, 1024, 1024))
# bytes of inputs D's timing cycles through, past the card's 50 MB L2
L2_BYTES = 50 * 2 ** 20
DROPOUT_TIMED_BYTES = 256 * 2 ** 20
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
# the cp phase: kernels A and A′ on row halves (partials of each half, the
# workspaces concatenated as the all-gather gives them, each half's apply)
# against the single call, relative to the largest value in fp32 (bf16: TOL);
# CP_WORLD gloo ranks on the one card against one process: MDViT's stage 0 at
# full width (64², B=16; output and gradients relative to their largest
# value: per-token products on half the rows may take other cuBLAS kernels),
# and BASE at full width at CP_IMG, B = CP_B (the size CP exists for): logits
# relative to max(1, max|logit|), the step's loss relative, BN stats relative
# to their largest value at JAX's DP×CP tolerance (a variance is E[x²] − mean²
# of sums over the ranks: where it is small against mean², its absolute
# noise is a larger share of it), gradients by GRAD_L2_TOL; the bf16 forward's
# logits against one process's fp32 logits (relative to max(1, max|logit|))
# no farther than CP_BF16_FACTOR times one process's bf16 logits are: a rank's
# GEMMs and convs run on fewer rows, where cuBLAS and cuDNN may take other
# kernels whose bf16 roundings differ, and 16 blocks carry an ulp's difference
# on, so the ranks' bf16 bits need not be one process's; A, B, C, A′, B′, C′
# launched once a block a rank (CP_BLOCKS blocks); steps timed
CP_WORLD = 2
CP_IMG = 512
CP_B = 2
CP_REL_TOL = 1e-6
CP_STAGE_TOL = 1e-5
CP_STAGE_GRAD_TOL = 1e-4
CP_FWD_TOL = 5e-4
CP_BF16_FACTOR = 2.0
CP_LOSS_RTOL = 1e-4
CP_BN_TOL = 1e-3
CP_BLOCKS = 16
# BASE's four token grids at CP_IMG (the stem /4, then /2 a stage), whose row
# halves a rank of the 2-rank step runs A and A′ on
CP_STAGES = [(CP_IMG // 4 >> i, CP_IMG // 4 >> i, c, ch) for i, (_, _, c, ch) in enumerate(STAGES)]
CP_TIMED = 2
CP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cp"
# ragged row blocks (H no multiple of the stride to the deepest grid; each
# grid's split from ``row_split``: rank r < n − 1 holds t·u_r rows of a grid
# of stride t to the deepest, the last rank the rest): BASE at 470² (grids
# 470, 235, 118, 59, 30, 15; the deepest 15 rows 7 + 8 on 2 ranks, the
# input 224 + 246, where balanced_rows' 8 + 7 would give 256 + 214; the
# stage grids 118², 59², 30², 15² split 56 + 62, 28 + 31, 14 + 16, 7 + 8),
# B = CP_B: A and A′ alone on those blocks (each rank's workspace padded to
# the most chunks with empty partials, also first in a rank's block: the
# padded fold bit-equal to the unpadded one) and B–C′ on each rank's halo'd
# block, as on the four-card split of CP_CARDS_UNEVEN_IMG² and coat_small's
# four scales at CP_CLS_IMG² (the cls row in rank 0's tokens; A and A′
# only), against the single call or full grid and the plain versions, each
# kernel's ms on each rank's block beside its bound; then the forward and a
# train step on 2 gloo ranks with the 512² run's gates; mpvit_base and
# coat_small at their published widths, CP_CLS_IMG², B=16 (CoaT's
# non-overlapping windows: grids 57, 28, 14, 7, floor drops, split 32 + 25,
# 16 + 12, 8 + 6, 4 + 3; MPViT's SAME convs: 115, 58, 29, 15, 8 split
# 64 + 51, 32 + 26, 16 + 13, 8 + 7, 4 + 4; CoaT's cls rows on rank 0): the
# eval forward's logits within CP_FWD_TOL of max(1, max|logit|), the summed
# gradients of a cross-entropy ÷ the ranks by GRAD_L2_TOL, A, B, C once a
# block a forward and A′, B′, C′ once a block a pull on every rank; MDViT
# with the DeepLabV3 debranch at full width, CP_DEEPLAB_IMG², B = CP_B: the
# eval forward's logits as the classifiers' and its launches those of one
# process; --dp-cards: ctx over four cards at CP_CARDS_UNEVEN_IMG² (the
# deepest 15 rows 4, 4, 4, 3; the input 128, 128, 128, 68) with the bf16
# gate. Each ragged record gives every grid's rows a rank
CP_UNEVEN_IMG = 470
CP_CLASSIFIERS = ("mpvit_base", "coat_small")
CP_CLS_IMG = 230
CP_DEEPLAB_IMG = 512
CP_CARDS_UNEVEN_IMG = 452
# the segmentation comparators under CP: one more 2-rank spawn at published
# widths (the registry's), fp32, B = CP_B, each model at its (H, W): the
# train-mode forward (batch moments, the running stats frozen; dropout from
# one generator seed: the unsharded masks' rows) against one process, every
# map and feat within CP_FWD_TOL of max(1, max|map|); the CP train step of
# the single-loss models (AdamW 1e-4, their own dropout) with the cp step's
# loss and BN-stat gates, its gradients held in fp64 (below); every port-kernel launch
# 0; a rank's step ms, busy ms and peak MiB (the forward's for TransFuse,
# which has no CP step) against one process. --dp-cards: CP_ZOO_CARDS with
# ctx over four NCCL cards at CP_IMG (its 16-row stage-3 grid 4 a rank: the
# windows of 8 span two ranks, the shift wraps from rank 3 to rank 0)
CP_ZOO = {"UTNet": (CP_IMG, CP_IMG), "SwinUnet": (CP_IMG, CP_IMG),
          "SwinUNETR": (CP_IMG, CP_IMG), "TransFuse_S": (CP_IMG, CP_IMG),
          "TransFuse_L_384": (384, 512)}
CP_ZOO_STEP = ("UTNet", "SwinUnet", "SwinUNETR")
CP_ZOO_CARDS = ("SwinUnet",)
# the split does not depend on the precision, so the comparators' step
# gradients are held in fp64 (every parameter, input and compute dtype),
# the ranks' against one process's, relative L2: UTNet's fp32 gradient at
# 512² sits near kinks (ReLU, max pool) where fp32 rounding alone moves it
# past GRAD_L2_TOL, so the fp32 gaps are recorded, not gated
CP_FP64_GRAD_TOL = 1e-9
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
# the classifiers phase: the ten MPViT and CoaT classifiers at their
# published widths (the JAX builders'), 224², B = 16, and each one's blocks:
# the launches of each of A, B and C a forward, and of A′, B′ and C′ a
# backward pull (MPViT Σ num_path·num_layers; CoaT Σ serial_depths +
# 3·parallel_depth, a parallel block attending at scales 2 to 4); forwards
# timed a dtype (after 2 warm-up calls)
CLASSIFIERS = {"mpvit_tiny": 23, "mpvit_xsmall": 23, "mpvit_small": 38, "mpvit_base": 44,
               "coat_tiny": 26, "coat_mini": 26, "coat_small": 26, "coat_lite_tiny": 8,
               "coat_lite_mini": 8, "coat_lite_small": 16}
CLS_IMG = 224
CLS_TIMED = 8
# CoaT's CPE and CRPE inputs, the image rows of (B, H·W + 1, ·) tokens, as
# (H, W, C) at 224²: coat_tiny's 152 channels and coat_mini's 216
COAT_VIEWS = [(56, 56, 152), (28, 28, 152), (14, 14, 152), (7, 7, 152), (28, 28, 216),
              (14, 14, 216), (7, 7, 216)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@functools.lru_cache(maxsize=None)
def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


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
    summary["classifier_shapes"] = classifier_kernels(seed, backward=False)
    failures += [r for r in summary["classifier_shapes"] if not r["ok"]]
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


def classifier_attention_calls(name: str) -> dict:
    """{(N, C, ch): calls of A a forward} of classifier ``name`` at 224², 8
    heads: MPViT's paths see N = H·W tokens, CoaT's blocks N = H·W + 1 (the
    cls row), its parallel blocks one call at each of scales 2 to 4."""
    grids = [CLS_IMG // 4 // 2 ** i for i in range(4)]
    calls: dict = defaultdict(int)
    if name in mpvit.CONFIGS:
        cfg = mpvit.CONFIGS[name]
        for i, g in enumerate(grids):
            c = cfg["embed_dims"][i]
            calls[(g * g, c, c // 8)] += cfg["num_path"][i] * cfg["num_layers"][i]
    else:
        cfg = coat.CONFIGS[name]
        for i, g in enumerate(grids):
            c = cfg["embed_dims"][i]
            calls[(g * g + 1, c, c // 8)] += (cfg["serial_depths"][i]
                                               + (cfg["parallel_depth"] if i else 0))
    return dict(calls)


def classifier_kernels(seed: int, backward: bool) -> list:
    """``kernel_classifier`` records: A (``backward``: A′) at every (N, C, ch)
    the classifiers send, q, k, v slices of one (B, N, 3C) projection; B and
    C (B′ and C′) on CoaT's views (``COAT_VIEWS``): x the image rows of
    (B, H·W + 1, C) tokens, q and v those of a (B, H·W + 1, 3C) projection.
    B=16, fp32 and bf16: the check against the plain version, bit-equal on a
    second call, device ms (the plain version's in fp32), the bound, and for
    B–C′ the library yardstick of phases 2 and 3 on the same views."""
    gen = torch.Generator().manual_seed(seed + (13 if backward else 12))

    def randn(*shape, dtype, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    shapes = sorted({s for name in CLASSIFIERS for s in classifier_attention_calls(name)})
    cases = ([("factorized_attention", s) for s in shapes]
             + [(k, v) for k in ("cpe_conv", "crpe_conv") for v in COAT_VIEWS])
    out = []
    for (kind, shape), dtype in itertools.product(cases, (torch.float32, torch.bfloat16)):
        item = 2 if dtype == torch.bfloat16 else 4
        w = lib_fn = None
        if kind == "factorized_attention":
            n, c, ch = shape
            where = {"N": n, "C": c, "ch": ch}
            qkv = randn(BATCH, n, 3 * c, dtype=dtype)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            n_el = BATCH * n * c
            if backward:
                args = (q, k, v, randn(BATCH, n, c, dtype=dtype), ch, ch ** -0.5)
                run = lambda: torch.ops.mdvit.factorized_attention_bwd(*args)
                plain = lambda: fa.factorized_attention_bwd_ref(*args)
                n_image, n_bytes, flops = 3, 7 * n_el * item, 10 * n_el * ch
            else:
                run = lambda: fa.factorized_attention(q, k, v, ch, ch ** -0.5)
                plain = lambda: fa.factorized_attention_ref(q, k, v, ch, ch ** -0.5)
                n_image, n_bytes, flops = 1, 4 * n_el * item, 4 * n_el * ch
        else:
            h, wd, c = shape
            where = {"H": h, "W": wd, "C": c, "view": "rows 1.. of (B, H*W+1, .) tokens"}
            n_el = BATCH * h * wd * c
            g = randn(BATCH, h, wd, c, dtype=dtype)
            if kind == "cpe_conv":
                x = randn(BATCH, h * wd + 1, c, dtype=dtype)[:, 1:].unflatten(1, (h, wd))
                w = randn(3, 3, c, std=(2 / 9) ** 0.5, dtype=dtype)
                b = randn(c, std=0.1, dtype=dtype)
                if backward:
                    run = lambda: torch.ops.mdvit.cpe_conv_bwd(x, w, g)
                    plain = lambda: dwconv.cpe_conv_bwd_ref(x, w, g)
                    n_image = 1
                    n_bytes = 3 * n_el * item + 9 * c * item + 10 * c * 4
                    flops = 4 * 9 * n_el + 2 * n_el
                else:
                    run = lambda: dwconv.cpe_conv(x, w, b)
                    plain = lambda: dwconv.cpe_conv_ref(x, w, b)
                    n_image = 1
                    n_bytes, flops = 2 * n_el * item + 10 * c * item, 2 * 9 * n_el + 2 * n_el
            else:
                qkv = randn(BATCH, h * wd + 1, 3 * c, dtype=dtype)[:, 1:].unflatten(1, (h, wd))
                q, v = qkv[..., :c], qkv[..., 2 * c:]
                w = randn(7, 7, c, std=(2 / 49) ** 0.5, dtype=dtype)
                b = randn(c, std=0.1, dtype=dtype)
                if backward:
                    run = lambda: torch.ops.mdvit.crpe_conv_bwd(q, v, w, b, g)
                    plain = lambda: dwconv.crpe_conv_bwd_ref(q, v, w, b, g)
                    n_image = 2
                    n_bytes = 5 * n_el * item + 50 * c * item + 50 * c * 4
                    flops = 6 * 49 * n_el + 4 * n_el
                else:
                    run = lambda: dwconv.crpe_conv(q, v, w, b)
                    plain = lambda: dwconv.crpe_conv_ref(q, v, w, b)
                    n_image = 1
                    n_bytes, flops = 3 * n_el * item + 50 * c * item, 2 * 49 * n_el + 2 * n_el
            # the depthwise conv alone (no residual, no gate), as phases 2 and 3 time it
            k = w.shape[0]
            img_nchw = (x if kind == "cpe_conv" else v).permute(0, 3, 1, 2)
            w_oihw = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            if backward:
                g_nchw = g.permute(0, 3, 1, 2)
                lib_fn = lambda: torch.ops.aten.convolution_backward(
                    g_nchw, img_nchw, w_oihw, [c], [1, 1], [k // 2] * 2, [1, 1], False,
                    [0, 0], c, [True, True, True])
            else:
                lib_fn = lambda: F.conv2d(img_nchw, w_oihw, b, padding=k // 2, groups=c)
        with torch.no_grad():
            got, again = run(), run()
            torch.cuda.synchronize()
            if backward:
                res = _compare_grads(_weights_apart(got, w), plain(), dtype, n_image)
            else:
                res = compare(got, plain(), dtype)
                got, again = (got,), (again,)
            res["bit_equal_repeat"] = all(torch.equal(a, e) for a, e in zip(got, again))
            res["ok"] &= res["bit_equal_repeat"]
            ms = device_ms(run)
            plain_ms = device_ms(plain) if dtype == torch.float32 else None
            library_ms = device_ms(lib_fn) if lib_fn else None
        b_ms, b_by = bound_ms(n_bytes, flops)
        rec = {"phase": "kernel_classifier", "kernel": kind + ("_bwd" if backward else ""),
               "B": BATCH, **where, "dtype": str(dtype).replace("torch.", ""), **res,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
               "bound_by": b_by, "roofline_share": b_ms / ms}
        emit(rec)
        out.append(rec)
        del got, again, run, plain, lib_fn
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
    summary["classifier_bwd_shapes"] = classifier_kernels(seed, backward=True)
    failures += [r for r in summary["classifier_bwd_shapes"] if not r["ok"]]
    if failures:
        raise RuntimeError(f"{len(failures)} backward kernel check(s) failed")
    return summary


def phase_dropout(seed: int) -> dict:
    """Kernel D (``mdvit::dropout``) at every call of phase 6's fp32 train
    step (D·B = 16, 256²: each call's x shape and counter layout as one step
    made them, read with ``layers._dropout_cuda`` wrapped) and at
    ``DROPOUT_SHAPES`` (element masks), in fp32 and bf16: bit-equal to its
    plain version (``layers.dropout_ref``, the torch formula, on the card),
    and device ms of both beside the bound (x read once, y written once).
    Returns D's summary, the per-step sums over phase 6's calls."""
    model, step, _ = _train_setup(torch.float32, seed)
    images, masks = _stores(seed)
    calls: dict = {}  # (shape, keep, row, stride, period) -> [calls, a key]
    real = layers._dropout_cuda

    def record(x, keep, key, row, stride, period):
        calls.setdefault((tuple(x.shape), keep, row, stride, period), [0, key])[0] += 1
        return real(x, keep, key, row, stride, period)

    with mock.patch.object(layers, "_dropout_cuda", record):
        step(images, masks, torch.arange(TRAIN_B).repeat(TRAIN_D, 1).cuda())
    torch.cuda.synchronize()
    del model, step, images, masks
    torch.cuda.empty_cache()
    n_calls = sum(n for n, _ in calls.values())
    if n_calls != sum(DROPOUT_CALLS):
        raise RuntimeError(f"train step made {n_calls} dropout calls, want {sum(DROPOUT_CALLS)}")
    cases = [(layout, n, key) for layout, (n, key) in calls.items()]
    for shape in DROPOUT_SHAPES:
        row = math.prod(shape[1:])
        cases.append(((shape, 0.9, row, row, row), None, 0x2545F491))
    summary = _summary(["dropout"])["dropout"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    failures = []
    for (shape, keep, row, stride, period), n, key in cases:
        for dtype in (torch.float32, torch.bfloat16):
            # copies of x past the L2 for the timed calls to cycle through:
            # where the graph's 20 calls cannot hold them, each reads x from
            # memory; smaller calls stay in the L2 (``in_l2``), as in the step
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            xs = [x] + [x.clone() for _ in range(DROPOUT_TIMED_BYTES // (
                x.numel() * x.element_size()))]
            args = (keep, key, row, stride, period)
            cycle = itertools.cycle(xs)
            run = lambda: layers._dropout_cuda(next(cycle), *args)
            plain = lambda: layers.dropout_ref(next(cycle), *args)
            got, want = layers._dropout_cuda(x, *args), layers.dropout_ref(x, *args)
            bit_equal = _same_bits(got, want)
            err = (got.float() - want.float()).abs().max().item()
            del got, want
            with torch.no_grad():
                ms, plain_ms = device_ms(run), device_ms(plain)
            item = x.element_size()
            n_bytes = 2 * x.numel() * item
            b_ms, b_by = bound_ms(n_bytes, x.numel())
            rec = {"phase": "kernel", "kernel": "dropout", "shape": list(shape), "keep": keep,
                   "row": row, "stride": stride, "period": period,
                   "calls_per_step": n, "dtype": str(dtype).replace("torch.", ""),
                   "bit_equal": bit_equal, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                   "roofline_share": b_ms / ms, "in_l2": 20 * n_bytes // 2 < L2_BYTES}
            emit(rec)
            if not bit_equal:
                failures.append(rec)
            if n is not None:
                _add(summary, rec, n)
            del x, xs, cycle
    summary["calls"] = n_calls
    if failures:
        raise RuntimeError(f"{len(failures)} dropout kernel check(s) not bit-equal")
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
    backwards and dropout (kernel D, its own backward) always, the forwards
    too unless ``forward`` is False. The ops' CUDA implementations call the
    plain versions (the ops' CPU implementations, which run on any device's
    tensors) in place of their launches; the ops and their autograd stay
    the same."""
    patches = [(fa, "_backward", fa._attention_bwd_cpu),
               (dwconv, "_cpe_backward", dwconv._cpe_bwd_cpu),
               (dwconv, "_crpe_backward", dwconv._crpe_bwd_cpu),
               (layers, "_dropout_cuda", layers.dropout_ref)]
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
    launches = _launches()
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
            plain_launches = _launches()
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
    launches = _launches()
    expected = {name: sum(FWD_CALLS) if name in FORWARD else sum(BWD_CALLS)
                for name in FORWARD + BACKWARD}
    expected["dropout"] = sum(DROPOUT_CALLS)
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
        plain_launches = _launches()
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
        all_launches = _launches()
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
        launches = _launches()
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
    # each train step runs every forward kernel once a block (16 blocks),
    # every backward kernel at BWD_CALLS and D at DROPOUT_CALLS; each eval
    # batch the forwards once a block
    expected = {name: (steps + eval_batches) * 16 if name in FORWARD
                else steps * sum(BWD_CALLS) for name in FORWARD + BACKWARD}
    expected["dropout"] = steps * sum(DROPOUT_CALLS)
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


def _launches() -> dict:
    """Every kernel's launch count: the six model kernels' and D's."""
    return dict(kernels.LAUNCHES)


def _model_kernels(launches: dict) -> dict:
    """The six model kernels' counts of ``launches``, which the blocks
    predict; D's follow the dropout sites."""
    return {k: launches[k] for k in FORWARD + BACKWARD}


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
    serve_launches = _launches()
    serve_fwd, serve_bwd = _split_launches(serve_launches)
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
    step_launches = _launches()
    step_fwd, step_bwd = _split_launches(step_launches)
    plain_step = _family_step(plain_model, seed)
    with plain_versions():
        kernels.reset_launches()
        plain_step(*batch_data)
        torch.cuda.synchronize()
        plain_launches = sum(_launches().values())
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
            "serving_dropout_launches": serve_launches["dropout"],
            "step_dropout_launches": step_launches["dropout"],
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
                and rec["serving_dropout_launches"] == 0 and rec["step_dropout_launches"] > 0
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
            launches = _launches()
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
            launches = _launches()
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
        launches = _launches()
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
    # D: every call of the plain step, and again where the replays redo a forward
    rec["launches_as_predicted"] = (
        _model_kernels(remat["launches"])
        == {k: fwd_pred if k in FORWARD else bwd_pred for k in FORWARD + BACKWARD}
        and _model_kernels(plain["launches"])
        == {k: 16 if k in FORWARD else bwd_pred for k in FORWARD + BACKWARD}
        and remat["launches"]["dropout"] >= plain["launches"]["dropout"] > 0)
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
    res["launches"] = _launches()
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
    expected["dropout"] = sum(DROPOUT_CALLS)
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
            and all(_model_kernels(r["launches"]) == _model_kernels(expected)
                    and r["launches"]["dropout"] > 0 for r in ranks)):
        raise RuntimeError(f"dp phase failed: {json.dumps(rec)[:2000]}")
    return r0["launches"]


# ----------------------------------------------------------------- cp


def _cp_attention(q, k, v, g, ch: int, tokens, plain: bool = False, front: bool = False,
                  pad: bool = True):
    """A and A′ as ranks holding ``tokens`` rows each run them: each block's
    partials, padded to the most chunks any block holds with empty partials
    (last, or ``front``: first in the block; ``pad`` False: concatenated
    as they are), in rank order (what the all-gather gives), each block's
    apply. Returns out, (dq, dk, dv) and the two workspaces."""
    scale = ch ** -0.5
    if plain:
        parts, apply = fa.factorized_attention_partials_ref, fa.factorized_attention_apply_ref
        bparts, bapply = fa.factorized_attention_bwd_partials_ref, fa.factorized_attention_bwd_apply_ref
    else:
        ops = torch.ops.mdvit
        parts, apply = ops.factorized_attention_partials, ops.factorized_attention_apply
        bparts, bapply = ops.factorized_attention_bwd_partials, ops.factorized_attention_bwd_apply
    cuts = np.cumsum((0,) + tuple(tokens))
    rows = [slice(int(cuts[i]), int(cuts[i + 1])) for i in range(len(tokens))]

    def gathered(blocks, grad):
        if not pad:
            return torch.cat(blocks, 1)
        most = max(-(-t // fa.chunk_rows(ch, grad)) for t in tokens)
        p = fa.partial_floats(ch, grad)
        out = []
        for ws in blocks:
            padded = fa.pad_partials(ws, most, ch, grad)
            if front:
                n_own = ws.shape[1] // p
                b3 = padded.reshape(ws.shape[0], most, p)
                padded = torch.cat([b3[:, n_own:], b3[:, :n_own]], 1).reshape(ws.shape[0], -1)
            out.append(padded)
        return torch.stack(out, 1).reshape(blocks[0].shape[0], -1)

    ws = gathered([parts(k[:, r], v[:, r], ch) for r in rows], False)
    out = torch.cat([apply(q[:, r], ws, ch, scale) for r in rows], 1)
    wsb = gathered([bparts(q[:, r], k[:, r], v[:, r], g[:, r], ch) for r in rows], True)
    grads = [torch.cat(d, 1) for d in zip(*[bapply(k[:, r], v[:, r], g[:, r], wsb, ch, scale)
                                             for r in rows])]
    return out, grads, ws, wsb


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


def _halo_rows(x: torch.Tensor, r0: int, rows: int, p: int) -> torch.Tensor:
    """The ``rows`` rows of x from row r0, with p rows of the zero-padded grid
    on each side."""
    return F.pad(x, (0, 0, 0, 0, p, p))[:, r0:r0 + rows + 2 * p]


def _add_halo(parts, h: int, starts, p: int) -> torch.Tensor:
    """The halo'd row blocks' gradients (block r from row ``starts[r]``)
    added into the grid (each halo row's into its owner's row), the padding
    cut off."""
    full = parts[0].new_zeros((parts[0].shape[0], h + 2 * p) + tuple(parts[0].shape[2:]))
    for r0, t in zip(starts, parts):
        full[:, r0:r0 + t.shape[1]] += t
    return full[:, p:p + h]


def _cp_halo_convs(x, q, v, g, wc, bc, wr, br, rows, dtype) -> tuple[dict, bool]:
    """B–C′ as ranks holding ``rows`` rows each of the (B, H, W, C) grids run
    them: each rank's rows plus its k//2 halo rows (CRPE's q and the output
    gradient zero-padded), the middle rows kept, B′'s dx and C′'s dv with the
    halo rows' gradients added into their owners' rows, dw and db summed
    over the ranks. Against the kernels on the full grid (``TOL``; dw, db
    within ``BWD_WEIGHT_REL_TOL``) and against the plain versions on the
    full grid (the same). Returns each check's relative error and whether
    all held."""
    h, c = x.shape[1], x.shape[3]
    starts = [int(s) for s in np.cumsum((0,) + tuple(rows))[:-1]]
    blocks = list(zip(starts, rows))
    own = lambda t, r0, n, p: _halo_rows(t[:, r0:r0 + n], 0, n, p)  # noqa: E731
    cpe = torch.cat([dwconv.cpe_conv(_halo_rows(x, r0, n, 1), wc, bc)[:, 1:-1]
                     for r0, n in blocks], 1)
    crpe = torch.cat([dwconv.crpe_conv(own(q, r0, n, 3), _halo_rows(v, r0, n, 3), wr, br)[:, 3:-3]
                      for r0, n in blocks], 1)
    cb = [torch.ops.mdvit.cpe_conv_bwd(_halo_rows(x, r0, n, 1), wc, own(g, r0, n, 1))
          for r0, n in blocks]
    rb = [torch.ops.mdvit.crpe_conv_bwd(own(q, r0, n, 3), _halo_rows(v, r0, n, 3), wr, br,
                                        own(g, r0, n, 3)) for r0, n in blocks]
    got = {"cpe_conv": cpe, "crpe_conv": crpe,
           "cpe_conv_bwd_dx": _add_halo([t[0] for t in cb], h, starts, 1),
           "crpe_conv_bwd_dq": torch.cat([t[0][:, 3:-3] for t in rb], 1),
           "crpe_conv_bwd_dv": _add_halo([t[1] for t in rb], h, starts, 3),
           "cpe_conv_bwd_dwb": sum(t[1] for t in cb), "crpe_conv_bwd_dwb": sum(t[2] for t in rb)}
    fcb = torch.ops.mdvit.cpe_conv_bwd(x, wc, g)
    frb = torch.ops.mdvit.crpe_conv_bwd(q, v, wr, br, g)
    full = {"cpe_conv": dwconv.cpe_conv(x, wc, bc), "crpe_conv": dwconv.crpe_conv(q, v, wr, br),
            "cpe_conv_bwd_dx": fcb[0], "crpe_conv_bwd_dq": frb[0], "crpe_conv_bwd_dv": frb[1],
            "cpe_conv_bwd_dwb": fcb[1], "crpe_conv_bwd_dwb": frb[2]}
    pcb = dwconv.cpe_conv_bwd_ref(x, wc, g)
    prb = dwconv.crpe_conv_bwd_ref(q, v, wr, br, g)
    stacked = lambda dw, db: torch.cat([dw.reshape(-1, c), db[None]])  # noqa: E731
    plain = {"cpe_conv": dwconv.cpe_conv_ref(x, wc, bc),
             "crpe_conv": dwconv.crpe_conv_ref(q, v, wr, br),
             "cpe_conv_bwd_dx": pcb[0], "crpe_conv_bwd_dq": prb[0], "crpe_conv_bwd_dv": prb[1],
             "cpe_conv_bwd_dwb": stacked(*pcb[1:]), "crpe_conv_bwd_dwb": stacked(*prb[2:])}
    res, ok = {}, True
    for against, want in (("full", full), ("plain", plain)):
        for name, t in got.items():
            if name.endswith("dwb"):
                rel = _rel(t, want[name])
                ok &= rel <= BWD_WEIGHT_REL_TOL and bool(torch.isfinite(t).all())
            else:
                chk = compare(t, want[name], dtype)
                rel, ok = chk["max_rel_err"], ok and chk["ok"]
            res[f"{name}_vs_{against}"] = rel
    return res, ok


def cp_kernels(seed: int) -> list:
    """The cp phase's kernels alone at MDViT's four stage shapes, B=16, and at
    the four grids of BASE at ``CP_IMG``, B = ``CP_B``, whose row halves are
    what a rank of the 2-rank step sends them (``CP_STAGES``): A and A′ on row
    halves against the single call (within ``CP_REL_TOL`` in fp32) and
    against the plain split; B–C′ on halo'd row halves against the full grid
    and the plain versions (``_cp_halo_convs``);
    device ms of one half's A (partials + apply) and A′ beside the single
    call's and their bounds (phase 2's work on a half's rows), and the bytes
    a rank's workspace sends to the gather."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    recs = []
    for (h, w, c, ch), batch in itertools.chain(((s, BATCH) for s in STAGES),
                                                 ((s, CP_B) for s in CP_STAGES)):
        n, h2 = h * w, h // 2
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, std=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

            q, k, v, g = rnd(batch, n, c), rnd(batch, n, c, std=3.0), rnd(batch, n, c), rnd(batch, n, c)
            scale = ch ** -0.5
            halves = (n // 2, n - n // 2)
            out, grads, ws, wsb = _cp_attention(q, k, v, g, ch, halves)
            single = fa.factorized_attention(q, k, v, ch, scale)
            single_g = torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ch, scale)
            p_out, p_grads, _, _ = _cp_attention(q, k, v, g, ch, halves, plain=True)
            rel_single = max(_rel(a, b) for a, b in zip([out, *grads], [single, *single_g]))
            checks = [compare(a, b, dtype) for a, b in zip([out, *grads], [p_out, *p_grads])]
            ok_single = rel_single <= (CP_REL_TOL if dtype == torch.float32 else TOL[dtype]["rel"])
            # B–C′ on the halo'd halves against the full grid and the plain versions
            wc, bc = rnd(3, 3, c, std=0.2).contiguous(), rnd(c, std=0.1)
            wr, br = rnd(7, 7, c, std=0.1).contiguous(), rnd(c, std=0.1)
            qg, vg, gg = (t.reshape(batch, h, w, c) for t in (q, v, g))
            halo, halo_ok = _cp_halo_convs(vg, qg, vg, gg, wc, bc, wr, br, (h2, h - h2), dtype)
            half = slice(0, n // 2)
            half_el, item = batch * (n // 2) * c, q.element_size()
            rec = {"phase": "cp", "part": "kernels", "shape": [batch, n, c, ch],
                   "dtype": str(dtype).replace("torch.", ""),
                   "split_vs_single_max_rel": rel_single,
                   "split_bit_equal_single": all(_same_bits(a, b) for a, b in
                                                 zip([out, *grads], [single, *single_g])),
                   "split_vs_plain": [ch_["max_rel_err"] for ch_ in checks],
                   "halo": halo,
                   "gather_bytes_per_rank": {"fwd": ws.numel() * 4 // 2, "bwd": wsb.numel() * 4 // 2},
                   "ms": {"A_single": device_ms(lambda: fa.factorized_attention(q, k, v, ch, scale)),
                          "A_half": device_ms(lambda: torch.ops.mdvit.factorized_attention_apply(
                              q[:, half], torch.ops.mdvit.factorized_attention_partials(
                                  k[:, half], v[:, half], ch), ch, scale)),
                          "A_bwd_single": device_ms(lambda: torch.ops.mdvit.factorized_attention_bwd(
                              q, k, v, g, ch, scale)),
                          "A_bwd_half": device_ms(lambda: torch.ops.mdvit.factorized_attention_bwd_apply(
                              k[:, half], v[:, half], g[:, half],
                              torch.ops.mdvit.factorized_attention_bwd_partials(
                                  q[:, half], k[:, half], v[:, half], g[:, half], ch), ch, scale))},
                   "bound_ms": {"A_half": bound_ms(4 * half_el * item, 4 * half_el * ch)[0],
                                "A_bwd_half": bound_ms(7 * half_el * item, 10 * half_el * ch)[0]},
                   "tol": {"split_vs_single_rel": CP_REL_TOL if dtype == torch.float32
                           else TOL[dtype]["rel"], **TOL[dtype]}}
            emit(rec)
            recs.append(rec)
            if not (ok_single and all(ch_["ok"] for ch_ in checks) and halo_ok):
                raise RuntimeError(f"cp kernels failed: {json.dumps(rec)[:2000]}")
    return recs


def grid_rows(img: int, world: int, chain=FATEncoderDecoder.row_chain) -> dict:
    """Every grid of ``chain`` at ``img``² over ``world`` ctx ranks, as the
    CP entry points split it (``row_split``): the deepest grid's rows a rank
    and each grid's rows a rank, by height."""
    units, grids = row_split(img, img, world, chain, 32)
    return {"deepest": list(units), "grids": {str(h): list(split) for h, _, split in grids}}


def _uneven_cases():
    """``cp_uneven_kernels``' cases: (case, B, (H, W, C, ch), each rank's rows
    of the grid, each rank's tokens, whether timed). BASE's four stage grids
    at ``CP_UNEVEN_IMG`` over ``CP_WORLD`` ranks (timed) and at
    ``CP_CARDS_UNEVEN_IMG`` over 4, B = ``CP_B``; ``coat_small``'s four
    serial scales at ``CP_CLS_IMG`` over ``CP_WORLD``, B = ``BATCH``, with
    the scale's cls row in rank 0's tokens; every split ``row_split``'s."""
    for img, world in ((CP_UNEVEN_IMG, CP_WORLD), (CP_CARDS_UNEVEN_IMG, 4)):
        _, grids = row_split(img, img, world, FATEncoderDecoder.row_chain, 32)
        for (_, _, c, ch), (h, w, rows) in zip(STAGES, grids[2:]):
            yield (f"BASE {img}² over {world}", CP_B, (h, w, c, ch), rows,
                   tuple(r * w for r in rows), world == CP_WORLD)
    _, grids = row_split(CP_CLS_IMG, CP_CLS_IMG, CP_WORLD, coat.CoaT.row_chain, 32)
    for c, (h, w, rows) in zip(coat.CONFIGS["coat_small"]["embed_dims"], grids[1:]):
        yield (f"coat_small {CP_CLS_IMG}² over {CP_WORLD}", BATCH, (h, w, c, c // 8), rows,
               tuple(r * w + (j == 0) for j, r in enumerate(rows)), False)


def _time_halo_convs(ms: dict, bound: dict, q, v, g, wc, bc, wr, br, rows, item: int) -> None:
    """Device ms of B, C, B′ and C′ on each rank's halo'd block of the
    (B, H, W, C) grids (``rows`` a rank; CPE's 1 halo row a side, CRPE's 3,
    q and the output gradient zero-padded, as the CP path sends them)
    beside their bounds over those rows, into ``ms`` and ``bound``."""
    batch, _, w, c = v.shape
    for r, (r0, n) in enumerate(zip(np.cumsum((0,) + tuple(rows))[:-1].tolist(), rows)):
        x1, g1 = _halo_rows(v, r0, n, 1), _halo_rows(g[:, r0:r0 + n], 0, n, 1)
        q3, v3 = _halo_rows(q[:, r0:r0 + n], 0, n, 3), _halo_rows(v, r0, n, 3)
        g3 = _halo_rows(g[:, r0:r0 + n], 0, n, 3)
        el1, el3 = batch * (n + 2) * w * c, batch * (n + 6) * w * c
        ms[f"B_rank{r}"] = device_ms(lambda: dwconv.cpe_conv(x1, wc, bc))
        ms[f"C_rank{r}"] = device_ms(lambda: dwconv.crpe_conv(q3, v3, wr, br))
        ms[f"B_bwd_rank{r}"] = device_ms(lambda: torch.ops.mdvit.cpe_conv_bwd(x1, wc, g1))
        ms[f"C_bwd_rank{r}"] = device_ms(
            lambda: torch.ops.mdvit.crpe_conv_bwd(q3, v3, wr, br, g3))
        bound[f"B_rank{r}"] = bound_ms(2 * el1 * item + 10 * c * item, 20 * el1)[0]
        bound[f"C_rank{r}"] = bound_ms(3 * el3 * item + 50 * c * item, 100 * el3)[0]
        bound[f"B_bwd_rank{r}"] = bound_ms(3 * el1 * item + 9 * c * item + 40 * c,
                                           38 * el1)[0]
        bound[f"C_bwd_rank{r}"] = bound_ms(5 * el3 * item + 50 * c * item + 200 * c,
                                           298 * el3)[0]


def cp_uneven_kernels(seed: int) -> list:
    """The kernels alone on the unequal row blocks the uneven CP paths send
    them (``_uneven_cases``), fp32 and bf16: A and A′ against the single call
    (in fp32 within ``CP_REL_TOL`` where every rank's block starts on one of
    the single call's chunk boundaries, else within ``TOL`` as against the
    plain version: the fold then sums other partials) and the plain split
    (``TOL``), the padded fold
    (empty partials last, and first in a rank's block) bit-equal to the
    unpadded fold on the same partials; B–C′ on each rank's halo'd block
    against the full grid and the plain versions (``_cp_halo_convs``; not
    at CoaT's cls-row tokens, whose convs see only image rows); device ms of
    each rank's A (its partials and its apply over the gathered, padded
    workspace), A′, and B–C′ on its halo'd block (``_time_halo_convs``)
    beside their bounds (phase 2's work on the rank's rows) at BASE's
    ``CP_UNEVEN_IMG`` blocks."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 66)
    recs = []
    for case, batch, (h, w, c, ch), rows, tokens, timed in _uneven_cases():
        n = sum(tokens)
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, std=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

            q, k, v, g = rnd(batch, n, c), rnd(batch, n, c, std=3.0), rnd(batch, n, c), rnd(batch, n, c)
            scale = ch ** -0.5
            out, grads, ws, wsb = _cp_attention(q, k, v, g, ch, tokens)
            front, front_grads, _, _ = _cp_attention(q, k, v, g, ch, tokens, front=True)
            bare, bare_grads, _, _ = _cp_attention(q, k, v, g, ch, tokens, pad=False)
            single = fa.factorized_attention(q, k, v, ch, scale)
            single_g = torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ch, scale)
            p_out, p_grads, _, _ = _cp_attention(q, k, v, g, ch, tokens, plain=True)
            got = [out, *grads]
            rel_single = max(_rel(a, b) for a, b in zip(got, [single, *single_g]))
            checks = [compare(a, b, dtype) for a, b in zip(got, [p_out, *p_grads])]
            pad_exact = all(_same_bits(a, b) for a, b in zip(got, [bare, *bare_grads]))
            front_exact = all(_same_bits(a, b) for a, b in zip([front, *front_grads], got))
            # every rank's first token on one of the single call's chunk
            # boundaries: the fold sums the single call's partials, fp32
            # within CP_REL_TOL; else other partials (TOL, as the plain version)
            aligned = all(int(t) % fa.chunk_rows(ch, grad) == 0
                          for t in np.cumsum(tokens)[:-1] for grad in (False, True))
            single_tol = CP_REL_TOL if dtype == torch.float32 and aligned else TOL[dtype]["rel"]
            ok_single = rel_single <= single_tol
            halo, halo_ok = None, True
            item = q.element_size()
            ms, bound = {}, {}
            if n == h * w:
                wc, bc = rnd(3, 3, c, std=0.2).contiguous(), rnd(c, std=0.1)
                wr, br = rnd(7, 7, c, std=0.1).contiguous(), rnd(c, std=0.1)
                qg, vg, gg = (t.reshape(batch, h, w, c) for t in (q, v, g))
                halo, halo_ok = _cp_halo_convs(vg, qg, vg, gg, wc, bc, wr, br, rows, dtype)
                if timed:
                    _time_halo_convs(ms, bound, qg, vg, gg, wc, bc, wr, br, rows, item)
            cuts = np.cumsum((0,) + tokens)
            for r in range(len(tokens) if timed else 0):
                sl = slice(int(cuts[r]), int(cuts[r + 1]))
                qr, kr, vr, gr = (t[:, sl] for t in (q, k, v, g))
                el = batch * tokens[r] * c
                ms[f"A_rank{r}"] = device_ms(lambda: (
                    torch.ops.mdvit.factorized_attention_partials(kr, vr, ch),
                    torch.ops.mdvit.factorized_attention_apply(qr, ws, ch, scale)))
                ms[f"A_bwd_rank{r}"] = device_ms(lambda: (
                    torch.ops.mdvit.factorized_attention_bwd_partials(qr, kr, vr, gr, ch),
                    torch.ops.mdvit.factorized_attention_bwd_apply(kr, vr, gr, wsb, ch, scale)))
                bound[f"A_rank{r}"] = bound_ms(4 * el * item, 4 * el * ch)[0]
                bound[f"A_bwd_rank{r}"] = bound_ms(7 * el * item, 10 * el * ch)[0]
            if timed:
                ms["A_single"] = device_ms(lambda: fa.factorized_attention(q, k, v, ch, scale))
                ms["A_bwd_single"] = device_ms(
                    lambda: torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ch, scale))
            rec = {"phase": "cp", "part": "uneven_kernels", "case": case,
                   "shape": [batch, n, c, ch], "grid": [h, w], "rows_per_rank": list(rows),
                   "tokens_per_rank": list(tokens), "dtype": str(dtype).replace("torch.", ""),
                   "chunks_per_rank": {"fwd": [-(-t // fa.chunk_rows(ch, False)) for t in tokens],
                                       "bwd": [-(-t // fa.chunk_rows(ch, True)) for t in tokens]},
                   "split_vs_single_max_rel": rel_single, "ranks_on_chunk_boundaries": aligned,
                   "split_vs_plain": [ch_["max_rel_err"] for ch_ in checks],
                   "padded_bit_equal_unpadded": pad_exact,
                   "empty_first_bit_equal_empty_last": front_exact,
                   "halo": halo, "ms": ms, "bound_ms": bound, "nvidia_smi": nvidia_smi(),
                   "tol": {"split_vs_single_rel": single_tol, **TOL[dtype]}}
            emit(rec)
            recs.append(rec)
            if not (ok_single and all(ch_["ok"] for ch_ in checks) and pad_exact
                    and front_exact and halo_ok):
                raise RuntimeError(f"cp uneven kernels failed: {json.dumps(rec)[:2000]}")
            del q, k, v, g, ws, wsb
    return recs


def _cp_stage(seed: int) -> torch.nn.Module:
    """MDViT's stage 0 at full width: dim 64, 2 blocks, 8 heads, MLP ratio 8,
    Sup gate, 4 domains."""
    torch.manual_seed(seed + 61)
    return MHSAStage(64, 2, 8, 8.0, TRAIN_D, sup=True).cuda().eval()


def _cp_inputs(seed: int, batch: int, img: int = CP_IMG):
    gen = torch.Generator().manual_seed(seed + 62)
    x = torch.randn((batch, img, img, 3), generator=gen)
    y = (torch.rand((batch, img, img, 1), generator=gen) > 0.5).float()
    dom = torch.eye(TRAIN_D)[torch.arange(batch) % TRAIN_D]
    return x.cuda(), y.cuda(), dom.cuda()


def _cp_base(seed: int, dtype=torch.float32, img: int = CP_IMG) -> torch.nn.Module:
    return build_model("BASE", img_size=img, num_domains=TRAIN_D, dtype=dtype,
                       device="cuda", seed=seed, drop_rate=0.1, drop_path_rate=0.1)


def _cp_run(seed: int, group, stage: bool = True, batch: int = CP_B, img: int = CP_IMG) -> dict:
    """What one rank of ``group`` (a process group or a ``ContextMesh``;
    None: one process) computes: MDViT's stage 0 (64², B=16) forward and the
    gradients of Σ out·g (summed over the ranks); BASE at ``img``, B =
    ``batch``: the bf16 and fp32 eval forwards' logits, one CP train step
    (AdamW 1e-4, wd 0.05) with the launches around it, its loss, gradients and BN stats; then
    ``CP_TIMED`` steps timed, one profiled, and the step's peak memory."""
    res = {}
    if stage:
        st = _cp_stage(seed)
        gen = torch.Generator(device="cuda").manual_seed(seed + 63)
        x = torch.randn((BATCH, 64 * 64, 64), generator=gen, device="cuda")
        g = torch.randn((BATCH, 64 * 64, 64), generator=gen, device="cuda")
        dom = torch.eye(TRAIN_D, device="cuda")[torch.arange(BATCH) % TRAIN_D]
        kernels.reset_launches()
        out = (stage_apply_context_parallel(st, x, (64, 64), group, dom) if group is not None
               else st(x, (64, 64), dom))
        grads = torch.autograd.grad((out * g).sum(), list(st.parameters()))
        res["stage_launches"] = _launches()
        if group is not None:
            flat = torch.cat([t.reshape(-1) for t in grads])
            torch.distributed.all_reduce(flat, group=group)
            grads = [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in grads]), grads)]
        res["stage_out"], res["stage_grads"] = out.detach().cpu(), [t.cpu() for t in grads]
        del st, x, g, out, grads
    x, y, dom = _cp_inputs(seed, batch, img)
    model = _cp_base(seed, torch.bfloat16, img).eval()
    with torch.no_grad():
        res["logits_bf16"] = model_apply_context_parallel(model, x, dom, group)["seg"].float().cpu()
    model = _cp_base(seed, img=img)
    with torch.no_grad():
        out = model_apply_context_parallel(model.eval(), x, dom, group)
    res["logits"] = out["seg"].cpu()
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
    step = make_context_parallel_train_step(model, opt, group)
    kernels.reset_launches()
    loss = step(x, y, dom, torch.Generator().manual_seed(seed + 64))
    torch.cuda.synchronize()
    res["launches"] = _launches()
    res["loss"] = loss.cpu()
    res["grads"] = [p.grad.detach().cpu() for p in model.parameters()]
    res["stats"] = [b.detach().cpu() for n, b in model.named_buffers() if "running" in n]
    gen = torch.Generator().manual_seed(seed + 65)
    lat = []
    for _ in range(CP_TIMED):
        _barrier(group)
        t0 = time.perf_counter()
        step(x, y, dom, gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"] = lat
    _barrier(group)
    res["device_busy_ms"] = _profile_calls(lambda: step(x, y, dom, gen), reps=1,
                                           cpu=False)["device_busy_ms"]
    _barrier(group)
    _reset_peak()
    step(x, y, dom, gen)
    torch.cuda.synchronize()
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    return res


def _barrier(group) -> None:
    if group is None:
        return
    g = group.grid if isinstance(group, ContextMesh) else group
    torch.distributed.barrier(group=g)


def _cp_rank(rank: int, seed: int, store: str, out: str, world: int, backend: str,
             grid, run, kwargs: dict) -> None:
    """A rank of the cp phase: ``run(seed, group, **kwargs)`` (``_cp_run`` or
    ``_cp_more_run``) in the group of all ranks (or the (data, ctx)
    ``grid``), saved to ``out/rank<r>.pt``; gloo ranks share card 0, an
    NCCL rank takes card r."""
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.distributed.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                         world_size=world)
    try:
        group = make_dp_context_mesh(*grid) if grid else torch.distributed.group.WORLD
        with no_tf32():
            res = run(seed, group, **kwargs)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


_CP_STORES = itertools.count()


def _cp_spawn(seed: int, world: int, backend: str, grid=None, run=None, **kwargs) -> list:
    """``world`` ranks of ``run`` (default ``_cp_run``) on a fresh file store,
    each's result."""
    store = CP_DIR / f"store{next(_CP_STORES)}"
    torch.multiprocessing.start_processes(
        _cp_rank, args=(seed, str(store), str(CP_DIR), world, backend, grid, run or _cp_run,
                        kwargs), nprocs=world, join=True, start_method="spawn")
    return [torch.load(CP_DIR / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _cp_compare(ranks: list, single: dict, stage: bool) -> dict:
    """The ranks' results against one process's: the stage's output and
    gradients (relative to their largest value), BASE's fp32 logits and its
    bf16 logits against one process's bf16 and fp32 logits (all relative to
    max(1, max|fp32 logit|)), the step's loss (relative), BN stats (relative to
    their largest value) and gradients (relative L2); the launches a rank."""
    r0 = ranks[0]
    scale = max(1.0, single["logits"].abs().max().item())
    rec = {"logits_err": max((r["logits"] - single["logits"]).abs().max().item()
                             for r in ranks) / scale,
           "logits_bf16_err": max((r["logits_bf16"] - single["logits_bf16"]).abs().max().item()
                                  for r in ranks) / scale,
           "logits_bf16_vs_fp32": max((r["logits_bf16"] - single["logits"]).abs().max().item()
                                      for r in ranks) / scale,
           "one_process_bf16_vs_fp32": (single["logits_bf16"] - single["logits"]).abs().max().item()
           / scale,
           "logits_bf16_finite": all(bool(torch.isfinite(r["logits_bf16"]).all()) for r in ranks),
           "loss_rel_err": max(abs(r["loss"].item() - single["loss"].item()) for r in ranks)
           / abs(single["loss"].item()),
           "bn_stats_rel_err": max(_rel_max(a, b) for r in ranks
                                   for a, b in zip(r["stats"], single["stats"])),
           "grad_l2_rel": max(_rel_l2(r["grads"], single["grads"]) for r in ranks),
           "replicas_bit_equal": all(_same_bits(a, b) for r in ranks[1:]
                                     for a, b in zip(r["grads"], r0["grads"])),
           "launches_per_rank": [r["launches"] for r in ranks],
           "step_ms": {"one_process": single["step_ms"],
                       **{f"rank{i}": r["step_ms"] for i, r in enumerate(ranks)}},
           "device_busy_ms": {"one_process": single["device_busy_ms"],
                              **{f"rank{i}": r["device_busy_ms"] for i, r in enumerate(ranks)}},
           "peak_mib": {"one_process": single["peak_mib"],
                        **{f"rank{i}": r["peak_mib"] for i, r in enumerate(ranks)}}}
    if stage:
        rec["stage_out_rel_err"] = max(_rel(r["stage_out"], single["stage_out"]) for r in ranks)
        rec["stage_grad_rel_err"] = max(_rel(a, b) for r in ranks
                                        for a, b in zip(r["stage_grads"], single["stage_grads"]))
        rec["stage_launches_per_rank"] = [r["stage_launches"] for r in ranks]
    return rec


def _cp_ok(rec: dict, stage: bool) -> bool:
    per_block = {k: CP_BLOCKS for k in FORWARD + BACKWARD}
    ok = (rec["logits_err"] <= CP_FWD_TOL and rec["logits_bf16_finite"]
          and rec["logits_bf16_vs_fp32"] <= CP_BF16_FACTOR * rec["one_process_bf16_vs_fp32"]
          and rec["loss_rel_err"] <= CP_LOSS_RTOL
          and rec["bn_stats_rel_err"] <= CP_BN_TOL and rec["grad_l2_rel"] <= GRAD_L2_TOL
          and rec["replicas_bit_equal"]
          and all(_model_kernels(n) == per_block for n in rec["launches_per_rank"]))
    if stage:
        ok = ok and (rec["stage_out_rel_err"] <= CP_STAGE_TOL
                     and rec["stage_grad_rel_err"] <= CP_STAGE_GRAD_TOL
                     and all(_model_kernels(n) == {k: 2 for k in FORWARD + BACKWARD}
                             for n in rec["stage_launches_per_rank"]))
    return ok


def cp_group_of_one(seed: int) -> dict:
    """An NCCL ctx group of one against no group: MDViT's stage 0 and BASE
    (256², B=2) forwards. The stage runs the same kernels on the same inputs
    (the split A folds the same partials in the same order; B and C compute
    each output's taps in one order whatever the tile, on explicit zero halo
    rows in place of their row padding), so its gate is bit-equality. BASE's
    strided and 3×3 convs read explicit zero halo rows with padding (0, 1) in
    place of padding (1, 1), which cuDNN may serve with another algorithm:
    the record says whether its bits held, and its gate is
    ``MODEL_REL_TOL``."""
    torch.distributed.init_process_group("nccl", init_method=f"file://{CP_DIR / 'nccl1'}",
                                         rank=0, world_size=1)
    try:
        world = torch.distributed.group.WORLD
        st = _cp_stage(seed)
        x = torch.randn((BATCH, 64 * 64, 64), generator=torch.Generator().manual_seed(seed)).cuda()
        dom = torch.eye(TRAIN_D, device="cuda")[torch.arange(BATCH) % TRAIN_D]
        with torch.no_grad():
            a, b = st(x, (64, 64), dom), stage_apply_context_parallel(st, x, (64, 64), world, dom)
            model = build_model("BASE", img_size=IMG, num_domains=TRAIN_D, device="cuda",
                                seed=seed).eval()
            xi = torch.randn((2, IMG, IMG, 3), generator=torch.Generator().manual_seed(seed)).cuda()
            m1 = model(xi, dom[:2])["seg"]
            m2 = model_apply_context_parallel(model, xi, dom[:2], world)["seg"]
    finally:
        torch.distributed.destroy_process_group()
    rec = {"stage_bit_equal": _same_bits(a, b), "stage_rel_err": _rel(b, a),
           "base_bit_equal": _same_bits(m1, m2), "base_rel_err": _rel(m2, m1)}
    if not (rec["stage_bit_equal"] and rec["base_rel_err"] <= MODEL_REL_TOL):
        raise RuntimeError(f"cp group of one failed: {rec}")
    return rec


def _cp_classifier(name: str, seed: int, group) -> dict:
    """``name`` at its published widths, ``CP_CLS_IMG``², B=16, on the card: the eval
    forward through ``model_apply_context_parallel`` over ``group`` (None:
    one process) with the launch counters read around it, then one backward
    pull of the mean cross-entropy with the counters read around it, its
    gradients summed over the ranks ÷ their count. One process saves its
    calibrated weights (MPViT's BNs, ``_cls_model``), logits and gradients
    to ``CP_DIR``; a rank loads the weights and compares with the rest."""
    x, labels = _cls_input(seed, CP_CLS_IMG)
    ref_path = CP_DIR / f"single_{name}.pt"
    if group is None:
        model = _cls_model(name, torch.float32, seed, x)
    else:
        model = build_model(name, device="cuda", seed=seed).eval()
        model.load_state_dict(torch.load(ref_path, weights_only=False)["state_dict"])
    kernels.reset_launches()
    out = model_apply_context_parallel(model, x, None, group)
    torch.cuda.synchronize()
    fwd = _launches()
    kernels.reset_launches()
    grads = torch.autograd.grad(F.cross_entropy(out["logits"], labels), list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    bwd = _launches()
    logits = out["logits"].detach().float().cpu()
    if group is None:
        torch.save({"state_dict": model.state_dict(), "logits": logits,
                    "grads": [t.cpu() for t in grads]}, ref_path)
        return {"forward_launches": fwd, "backward_pull_launches": bwd,
                "finite": bool(torch.isfinite(logits).all())}
    flat = torch.cat([t.reshape(-1) for t in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat /= torch.distributed.get_world_size(group)
    ref = torch.load(ref_path, weights_only=False)
    want = torch.cat([t.reshape(-1) for t in ref["grads"]]).cuda()
    scale = max(1.0, ref["logits"].abs().max().item())
    return {"forward_launches": fwd, "backward_pull_launches": bwd,
            "finite": bool(torch.isfinite(logits).all()),
            "logits_err": (logits - ref["logits"]).abs().max().item() / scale,
            "grad_l2_rel": ((flat.double() - want.double()).norm() / want.double().norm()).item()}


def _cp_deeplab(seed: int, group) -> dict:
    """MDViT with the DeepLabV3 debranch at full width, ``CP_DEEPLAB_IMG``²,
    B = ``CP_B``: the eval forward's logits over ``group`` (None: one
    process) with the launch counters read around it."""
    model = build_model("MDViT", img_size=CP_DEEPLAB_IMG, num_domains=TRAIN_D,
                        decoder_name="DeepLabV3", device="cuda", seed=seed).eval()
    x, _, dom = _cp_inputs(seed, CP_B, CP_DEEPLAB_IMG)
    kernels.reset_launches()
    with torch.no_grad():
        logits = split_seg(model_apply_context_parallel(model, x, dom, group)["seg"])[0]
    torch.cuda.synchronize()
    return {"launches": _launches(), "logits": logits.float().cpu()}


def _cp_more_run(seed: int, group) -> dict:
    """What one rank of ``group`` (None: one process) computes of the uneven
    splits: BASE at ``CP_UNEVEN_IMG`` (``_cp_run``), the ``CP_CLASSIFIERS``
    and MDViT's DeepLabV3 debranch."""
    res = {"base": _cp_run(seed, group, stage=False, img=CP_UNEVEN_IMG)}
    torch.cuda.empty_cache()
    res["classifiers"] = {}
    for name in CP_CLASSIFIERS:
        res["classifiers"][name] = _cp_classifier(name, seed, group)
        torch.cuda.empty_cache()
    res["deeplab"] = _cp_deeplab(seed, group)
    return res


def _cp_more_records(ranks: list, single: dict) -> list:
    """The uneven splits' records, each with ``ok``: BASE at
    ``CP_UNEVEN_IMG`` as the 512² run, the classifiers and DeepLabV3."""
    base = {"phase": "cp", "part": "uneven_ranks", "world": len(ranks), "backend": "gloo",
            "img": CP_UNEVEN_IMG, "B": CP_B, "nvidia_smi": nvidia_smi(),
            "rows_per_rank": grid_rows(CP_UNEVEN_IMG, len(ranks)),
            **_cp_compare([r["base"] for r in ranks], single["base"], False),
            "tol": {"logits": CP_FWD_TOL, "logits_bf16_vs_fp32_factor": CP_BF16_FACTOR,
                    "loss_rel": CP_LOSS_RTOL, "bn_rel": CP_BN_TOL, "grad_l2": GRAD_L2_TOL}}
    base["ok"] = _cp_ok(base, False)
    recs = [base]
    for name in CP_CLASSIFIERS:
        blocks = CLASSIFIERS[name]
        one = single["classifiers"][name]
        per = [r["classifiers"][name] for r in ranks]
        chain = (mpvit.MPViT if name.startswith("mpvit") else coat.CoaT).row_chain
        rec = {"phase": "cp", "part": "classifier", "model": name, "world": len(ranks),
               "img": CP_CLS_IMG, "B": BATCH, "blocks": blocks, "nvidia_smi": nvidia_smi(),
               "rows_per_rank": grid_rows(CP_CLS_IMG, len(ranks), chain),
               "logits_err": max(p["logits_err"] for p in per),
               "grad_l2_rel": max(p["grad_l2_rel"] for p in per),
               "forward_launches_per_rank": [p["forward_launches"] for p in per],
               "backward_pull_launches_per_rank": [p["backward_pull_launches"] for p in per],
               "one_process_launches": [one["forward_launches"], one["backward_pull_launches"]],
               "tol": {"logits": CP_FWD_TOL, "grad_l2": GRAD_L2_TOL}}
        fwd_want = {k: blocks if k in FORWARD else 0 for k in FORWARD + BACKWARD}
        bwd_want = {k: blocks if k in BACKWARD else 0 for k in FORWARD + BACKWARD}
        rec["ok"] = (rec["logits_err"] <= CP_FWD_TOL and rec["grad_l2_rel"] <= GRAD_L2_TOL
                     and one["finite"] and all(p["finite"] for p in per)
                     and all(_model_kernels(p["forward_launches"]) == fwd_want for p in per)
                     and all(_model_kernels(p["backward_pull_launches"]) == bwd_want
                             for p in per))
        recs.append(rec)
    one = single["deeplab"]
    scale = max(1.0, one["logits"].abs().max().item())
    rec = {"phase": "cp", "part": "deeplabv3", "model": "MDViT_DeepLabV3", "world": len(ranks),
           "img": CP_DEEPLAB_IMG, "B": CP_B,
           "logits_err": max((r["deeplab"]["logits"] - one["logits"]).abs().max().item()
                             for r in ranks) / scale,
           "launches_per_rank": [r["deeplab"]["launches"] for r in ranks],
           "one_process_launches": one["launches"], "tol": {"logits": CP_FWD_TOL}}
    rec["ok"] = (rec["logits_err"] <= CP_FWD_TOL
                 and all(bool(torch.isfinite(r["deeplab"]["logits"]).all()) for r in ranks)
                 and all(r["deeplab"]["launches"] == one["launches"] for r in ranks)
                 and all(one["launches"][k] == CP_BLOCKS for k in FORWARD))
    recs.append(rec)
    return recs


def _cp_zoo_one(name: str, seed: int, group) -> dict:
    """``name`` (``CP_ZOO``) over ``group`` (None: one process): the
    train-mode forward under frozen running stats with the launch counters
    read around it, then timed with its peak; for ``CP_ZOO_STEP``, one CP
    train step with the counters around it (loss, gradients, BN stats),
    ``CP_TIMED`` steps timed, one profiled, and the step's peak."""
    h, w = CP_ZOO[name]
    model = build_model(name, img_size=h, num_domains=TRAIN_D, device="cuda", seed=seed).train()
    gen = torch.Generator().manual_seed(seed + 66)
    x = torch.randn((CP_B, h, w, 3), generator=gen).cuda()
    y = (torch.rand((CP_B, h, w, 1), generator=gen) > 0.5).float().cuda()
    dom = torch.eye(TRAIN_D)[torch.arange(CP_B) % TRAIN_D].cuda()

    def forward():
        with torch.no_grad(), running_stats_frozen():
            return model_apply_context_parallel(model, x, dom, group, train=True,
                                                gen=torch.Generator().manual_seed(seed + 67))

    kernels.reset_launches()
    out = forward()
    torch.cuda.synchronize()
    res = {"forward_launches": _launches(),
           "maps": [m.float().cpu() for m in _maps(out)], "feat": out["feat"].float().cpu(),
           "split_stride": getattr(model, "row_split_stride", 32)}
    del out
    _barrier(group)
    _reset_peak()
    t0 = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    res["forward_ms"] = (time.perf_counter() - t0) * 1e3
    res["forward_peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    if name not in CP_ZOO_STEP:
        return res
    res["grads_fp64"] = _step_grads_fp64(name, seed, x, y, dom, group)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
    step = make_context_parallel_train_step(model, opt, group)
    kernels.reset_launches()
    res["loss"] = step(x, y, dom, torch.Generator().manual_seed(seed + 68)).cpu()
    torch.cuda.synchronize()
    res["step_launches"] = _launches()
    res["grads"] = [p.grad.detach().cpu() for p in model.parameters()]
    res["stats"] = [b.detach().cpu() for n, b in model.named_buffers() if "running" in n]
    gen = torch.Generator().manual_seed(seed + 69)
    lat = []
    for _ in range(CP_TIMED):
        _barrier(group)
        t0 = time.perf_counter()
        step(x, y, dom, gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"] = lat
    _barrier(group)
    res["device_busy_ms"] = _profile_calls(lambda: step(x, y, dom, gen), reps=1,
                                           cpu=False)["device_busy_ms"]
    _barrier(group)
    _reset_peak()
    step(x, y, dom, gen)
    torch.cuda.synchronize()
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    return res


def _step_grads_fp64(name: str, seed: int, x, y, dom, group) -> list:
    """The gradients of ``_cp_zoo_one``'s step of ``name`` over ``group``
    (None: one process) on ``x``, the same dropout masks, with every
    parameter, input, compute dtype, fp32 cast (the norms', the moments')
    and constant matrix (the resizes') in fp64."""
    model = build_model(name, img_size=CP_ZOO[name][0], num_domains=TRAIN_D, device="cuda",
                        seed=seed).train().double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    step = make_context_parallel_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                            group)
    constant = resize_module.device_constant
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(torch.Tensor, "float", lambda t: t.to(torch.float64)), \
                mock.patch.object(resize_module, "device_constant",
                                  lambda *a: constant(*a).double()):
            step(x.double(), y.double(), dom.double(), torch.Generator().manual_seed(seed + 68))
    finally:
        torch.set_default_dtype(default)
    grads = [p.grad.detach().cpu() for p in model.parameters()]
    del model, step
    torch.cuda.empty_cache()
    return grads


def _cp_zoo_run(seed: int, group, names=tuple(CP_ZOO)) -> dict:
    """``_cp_zoo_one`` of each of ``names``, with its seconds."""
    res = {}
    for name in names:
        t0 = time.perf_counter()
        res[name] = _cp_zoo_one(name, seed, group)
        res[name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return res


def _cp_zoo_records(ranks: list, single: dict, part: str = "zoo") -> list:
    """One record a comparator, each with ``ok``: the forward's maps and
    feat a rank against one process (relative to max(1, max|map|)), for the
    step models the step's loss, BN stats and gradients, every launch
    counter (0), and a rank's ms and peak beside one process's."""
    recs = []
    for name, one in single.items():
        per = [r[name] for r in ranks]
        scale = max(1.0, max(m.abs().max().item() for m in one["maps"]))
        fscale = max(1.0, one["feat"].abs().max().item())
        rec = {"phase": "cp", "part": part, "model": name, "world": len(ranks),
               "img": list(CP_ZOO[name]), "B": CP_B,
               "deepest_rows_per_rank": list(balanced_rows(CP_ZOO[name][0] // one["split_stride"],
                                                           len(ranks))),
               "maps": len(one["maps"]),
               "maps_err": max((a - b).abs().max().item() for p in per
                               for a, b in zip(p["maps"], one["maps"])) / scale,
               "feat_err": max((p["feat"] - one["feat"]).abs().max().item()
                               for p in per) / fscale,
               "finite": all(bool(torch.isfinite(m).all()) for p in [one, *per]
                             for m in p["maps"]),
               "launches_per_rank": [{k: v for k, v in p.items() if k.endswith("_launches")}
                                     for p in per],
               "forward_ms": {"one_process": one["forward_ms"],
                              **{f"rank{i}": p["forward_ms"] for i, p in enumerate(per)}},
               "forward_peak_mib": {"one_process": one["forward_peak_mib"],
                                    **{f"rank{i}": p["forward_peak_mib"]
                                       for i, p in enumerate(per)}},
               "seconds": {"one_process": one["seconds"],
                           **{f"rank{i}": p["seconds"] for i, p in enumerate(per)}},
               "tol": {"maps": CP_FWD_TOL}}
        launches = [one["forward_launches"], *(p["forward_launches"] for p in per)]
        ok = (rec["maps_err"] <= CP_FWD_TOL and rec["feat_err"] <= CP_FWD_TOL and rec["finite"])
        if name in CP_ZOO_STEP:
            rec.update({
                "loss_rel_err": max(abs(p["loss"].item() - one["loss"].item()) for p in per)
                / abs(one["loss"].item()),
                "bn_stats_rel_err": max((_rel_max(a, b) for p in per
                                         for a, b in zip(p["stats"], one["stats"])),
                                        default=0.0),
                "grad_fp64_l2_rel": max(_rel_l2(p["grads_fp64"], one["grads_fp64"])
                                        for p in per),
                "grad_l2_rel": max(_rel_l2(p["grads"], one["grads"]) for p in per),
                "one_process_vs_fp64": _rel_l2(one["grads"], one["grads_fp64"]),
                "ranks_vs_fp64": max(_rel_l2(p["grads"], one["grads_fp64"]) for p in per),
                "step_ms": {"one_process": one["step_ms"],
                            **{f"rank{i}": p["step_ms"] for i, p in enumerate(per)}},
                "device_busy_ms": {"one_process": one["device_busy_ms"],
                                   **{f"rank{i}": p["device_busy_ms"]
                                      for i, p in enumerate(per)}},
                "peak_mib": {"one_process": one["peak_mib"],
                             **{f"rank{i}": p["peak_mib"] for i, p in enumerate(per)}}})
            rec["tol"].update({"loss_rel": CP_LOSS_RTOL, "bn_rel": CP_BN_TOL,
                               "grad_fp64_l2": CP_FP64_GRAD_TOL})
            launches += [one["step_launches"], *(p["step_launches"] for p in per)]
            ok = ok and (rec["loss_rel_err"] <= CP_LOSS_RTOL
                         and rec["bn_stats_rel_err"] <= CP_BN_TOL
                         and rec["grad_fp64_l2_rel"] <= CP_FP64_GRAD_TOL)
        rec["ok"] = ok and all(n == 0 for launch in launches
                               for n in _model_kernels(launch).values())
        recs.append(rec)
    return recs


def _zoo_launches(ranks: list) -> dict:
    """Rank 0's port-kernel launches over the comparators' CP forwards and
    steps."""
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    for res in ranks[0].values():
        for key in ("forward_launches", "step_launches"):
            for k, v in res.get(key, {}).items():
                total[k] = total.get(k, 0) + v
    return total


def phase_cp(seed: int) -> dict:
    """Context parallelism on the card: (1) the kernels alone on row halves
    (``cp_kernels``) and on the uneven paths' unequal blocks
    (``cp_uneven_kernels``); (2) a ctx group of one against no group
    (``cp_group_of_one``); (3) ``CP_WORLD`` gloo ranks on card 0 against one
    process: MDViT's stage 0 at full width forward and backward, BASE at full
    width at ``CP_IMG``, B = ``CP_B``: the forward, one train step, the
    launches a rank (A, B, C, A′, B′, C′ once a block), step ms, device-busy
    ms and peak MiB a rank against one process. Returns rank 0's step
    launches."""
    shutil.rmtree(CP_DIR, ignore_errors=True)
    CP_DIR.mkdir(parents=True)
    cp_kernels(seed)
    cp_uneven_kernels(seed)
    one = cp_group_of_one(seed)
    single = _cp_run(seed, None)
    ranks = _cp_spawn(seed, CP_WORLD, "gloo")
    rec = {"phase": "cp", "part": "ranks", "world": CP_WORLD, "backend": "gloo",
           "img": CP_IMG, "B": CP_B, "stage": [BATCH, 64 * 64, 64, 8],
           "group_of_one_nccl": one, **_cp_compare(ranks, single, True),
           "tol": {"logits": CP_FWD_TOL, "logits_bf16_vs_fp32_factor": CP_BF16_FACTOR,
                   "loss_rel": CP_LOSS_RTOL, "bn_rel": CP_BN_TOL,
                   "grad_l2": GRAD_L2_TOL, "stage_out_rel": CP_STAGE_TOL,
                   "stage_grad_rel": CP_STAGE_GRAD_TOL}}
    emit(rec)
    if not _cp_ok(rec, True):
        raise RuntimeError(f"cp phase failed: {json.dumps(rec)[:2000]}")
    del single
    more_single = _cp_more_run(seed, None)
    torch.cuda.empty_cache()
    more = _cp_spawn(seed, CP_WORLD, "gloo", run=_cp_more_run)
    failed = []
    for r in _cp_more_records(more, more_single):
        emit(r)
        if not r["ok"]:
            failed.append(r.get("model", r["part"]))
    zoo_single = _cp_zoo_run(seed, None)
    torch.cuda.empty_cache()
    zoo = _cp_spawn(seed, CP_WORLD, "gloo", run=_cp_zoo_run)
    for r in _cp_zoo_records(zoo, zoo_single):
        emit(r)
        if not r["ok"]:
            failed.append(r["model"])
    shutil.rmtree(CP_DIR, ignore_errors=True)
    if failed:
        raise RuntimeError(f"cp phase's uneven splits or comparators failed: {failed}")
    cls = dict.fromkeys(kernels.LAUNCHES, 0)
    for name in CP_CLASSIFIERS:
        for launches in (more[0]["classifiers"][name]["forward_launches"],
                         more[0]["classifiers"][name]["backward_pull_launches"]):
            for k in cls:
                cls[k] += launches[k]
    return {f"cp train step fp32 BASE {CP_IMG}, rank 0 of {CP_WORLD}": ranks[0]["launches"],
            f"cp train step fp32 BASE {CP_UNEVEN_IMG} (ragged rows), rank 0 of {CP_WORLD}":
                more[0]["base"]["launches"],
            f"cp forward + pull {' + '.join(CP_CLASSIFIERS)}, rank 0 of {CP_WORLD}": cls,
            f"cp forward MDViT_DeepLabV3 {CP_DEEPLAB_IMG}, rank 0 of {CP_WORLD}":
                more[0]["deeplab"]["launches"],
            f"cp forward + step {' + '.join(CP_ZOO)}, rank 0 of {CP_WORLD}":
                _zoo_launches(zoo)}


def phase_cp_cards(seed: int) -> None:
    """With ``--dp-cards``: ctx over every visible card (one NCCL rank a card)
    at ``CP_IMG``, B = ``CP_B``, then the (2, 2) data × ctx grid at B = 4,
    each against one process on card 0."""
    shutil.rmtree(CP_DIR, ignore_errors=True)
    CP_DIR.mkdir(parents=True)
    world = torch.cuda.device_count()
    runs = ([("ctx", None, CP_B, CP_IMG)]
            + ([("ctx_uneven", None, CP_B, CP_CARDS_UNEVEN_IMG), ("dp_x_cp", (2, 2), 4, CP_IMG)]
               if world == 4 else []))
    for name, grid, batch, img in runs:
        single = _cp_run(seed, None, stage=False, batch=batch, img=img)
        ranks = _cp_spawn(seed, world, "nccl", grid, stage=False, batch=batch, img=img)
        rec = {"phase": "cp", "part": name, "world": world, "backend": "nccl",
               "grid": grid or [1, world], "img": img, "B": batch, "nvidia_smi": nvidia_smi(),
               "rows_per_rank": grid_rows(img, grid[1] if grid else world),
               **_cp_compare(ranks, single, False)}
        emit(rec)
        if not _cp_ok(rec, False):
            raise RuntimeError(f"cp {name} failed: {json.dumps(rec)[:2000]}")
    if world == 4:
        single = _cp_zoo_run(seed, None, CP_ZOO_CARDS)
        ranks = _cp_spawn(seed, world, "nccl", run=_cp_zoo_run, names=CP_ZOO_CARDS)
        for rec in _cp_zoo_records(ranks, single, "zoo_cards"):
            emit({**rec, "backend": "nccl"})
            if not rec["ok"]:
                raise RuntimeError(f"cp zoo_cards failed: {json.dumps(rec)[:2000]}")
    shutil.rmtree(CP_DIR, ignore_errors=True)


# ----------------------------------------------------------------- zoo


def _zoo_model(name: str, dtype, seed: int, device: str = "cuda"):
    return build_model(name, img_size=IMG, num_domains=TRAIN_D, dtype=dtype, device=device,
                       seed=seed)


def _maps(out: dict) -> list:
    """Every map a model returns (TransFuse: map_x, map_1, map_2)."""
    seg = out["seg"]
    return list(seg) if isinstance(seg, tuple) else [seg]


def _add_launches(total: dict) -> None:
    for k, v in _launches().items():
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
    serve = _launches()
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
            card_launches = _launches()
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
    if any(_model_kernels(launches).values()):
        failures.append(f"launches {launches}")
    if failures:
        raise RuntimeError(f"zoo phase failed: {failures}")
    return launches


# ----------------------------------------------------------------- phase 15


def _cls_input(seed: int, img: int = CLS_IMG):
    """B=16 normal images at ``img``² and their labels."""
    gen = torch.Generator().manual_seed(seed + 17)
    x = torch.randn(BATCH, img, img, 3, generator=gen)
    return x.cuda(), torch.randint(0, 1000, (BATCH,), generator=gen).cuda()


def _cls_model(name: str, dtype, seed: int, x):
    """The registry model on the card in eval mode, its BNs (MPViT's)
    calibrated as the family's are."""
    model = build_model(name, dtype=dtype, device="cuda", seed=seed)
    if any(isinstance(m, DomainBatchNorm) for m in model.modules()):
        _calibrate_bn(model, x, None, FAMILY_BN_PASSES)
    return model.eval()


def _kernel_sums(calls: dict, records: list, kind: str) -> dict:
    """Device ms and bound ms of ``kind`` summed over one forward's (or
    backward pull's) calls, per dtype, from the ``kernel_classifier`` records."""
    by = {(r["N"], r["C"], r["ch"], r["dtype"]): r for r in records if r["kernel"] == kind}
    return {d: {k: sum(n * by[(*s, d)][k] for s, n in calls.items())
                for k in ("ms", "bound_ms")} for d in ("float32", "bfloat16")}


def classifier_row(name: str, seed: int, x, labels, shape_records: list) -> dict:
    """One ``classifier`` record (phase 15)."""
    t0 = time.perf_counter()
    model = _cls_model(name, torch.float32, seed, x)
    kernels.reset_launches()
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    fwd = _launches()
    with torch.no_grad(), plain_versions():
        kernels.reset_launches()
        want = model(x)
        torch.cuda.synchronize()
        plain_launches = sum(_launches().values())
    scale = max(1.0, want["logits"].abs().max().item())
    logit_err = (out["logits"] - want["logits"]).abs().max().item() / scale
    feat_err = ((out["feat"] - want["feat"]).abs().max().item()
                / max(1.0, want["feat"].abs().max().item()))
    finite = bool(torch.isfinite(out["logits"]).all()) and bool(torch.isfinite(out["feat"]).all())
    shape = list(out["logits"].shape)
    del out, want

    # one cross-entropy backward pull through the kernels, every counter read
    # around it, then the same through the plain versions from the same weights
    kernels.reset_launches()
    F.cross_entropy(model(x)["logits"], labels).backward()
    torch.cuda.synchronize()
    bwd = _launches()
    grads = [p.grad for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    with plain_versions():
        F.cross_entropy(model(x)["logits"], labels).backward()
    num = sum(((g - p.grad) ** 2).sum().item() for g, p in zip(grads, model.parameters()))
    den = sum((p.grad ** 2).sum().item() for p in model.parameters())
    grad_l2 = (num / den) ** 0.5
    model.zero_grad(set_to_none=True)
    del grads

    model16 = _cls_model(name, torch.bfloat16, seed, x)
    with torch.no_grad():
        l16 = model16(x)["logits"].float()
        with plain_versions():
            p16 = model16(x)["logits"].float()
    bf16 = {"finite": bool(torch.isfinite(l16).all()),
            "rel_err_vs_plain": (l16 - p16).abs().max().item() / max(1.0, p16.abs().max().item())}
    del l16, p16

    speed = {}
    for dtype_name, m in (("float32", model), ("bfloat16", model16)):
        call = lambda: m(x)
        with torch.no_grad():
            _reset_peak()
            t = _time_calls(call, BATCH, CLS_TIMED, warmup=2)
            peak = torch.cuda.max_memory_allocated()
            p = _profile_calls(call, reps=2, cpu=False)
        speed[dtype_name] = {"img_per_s": t["img_per_s"], "latency_ms_mean": t["latency_ms_mean"],
                             "device_busy_ms": p["device_busy_ms"],
                             "idle_share": 1 - p["device_busy_ms"] / t["latency_ms_mean"],
                             "device_ops_per_call": p["device_ops_per_call"],
                             "attention_fwd_ms_per_call": p["attention_fwd_ms_per_call"],
                             "peak_mib": peak / 2 ** 20}
    del model, model16
    torch.cuda.empty_cache()
    calls = classifier_attention_calls(name)
    return {"phase": "classifier", "model": name, "img": CLS_IMG, "B": BATCH,
            "blocks": CLASSIFIERS[name], "logits_shape": shape, "forward_launches": fwd,
            "backward_pull_launches": bwd, "plain_launches": plain_launches,
            "logit_scale": scale, "logit_rel_err": logit_err, "feat_rel_err": feat_err,
            "tol_rel": MODEL_REL_TOL, "finite": finite, "grad_l2_rel_err": grad_l2,
            "grad_l2_tol": GRAD_L2_TOL, "bf16": bf16, "speed": speed,
            "attention_calls": {f"N{n}_C{c}_ch{ch}": k for (n, c, ch), k in calls.items()},
            "A_per_forward": _kernel_sums(calls, shape_records, "factorized_attention"),
            "A_bwd_per_pull": _kernel_sums(calls, shape_records, "factorized_attention_bwd"),
            "seconds": time.perf_counter() - t0}


def phase_classifiers(seed: int, summary: dict) -> dict:
    """``classifier_row`` for each of ``CLASSIFIERS``; fails unless every
    gate holds. Returns the launches of each kernel over the ten fp32
    forwards and backward pulls, the phase's main path."""
    x, labels = _cls_input(seed)
    records = summary["classifier_shapes"] + summary["classifier_bwd_shapes"]
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    failures = []
    for name, blocks in CLASSIFIERS.items():
        if sum(classifier_attention_calls(name).values()) != blocks:
            raise RuntimeError(f"{name}: its config gives another block count than {blocks}")
        rec = classifier_row(name, seed, x, labels, records)
        emit(rec)
        for launches in (rec["forward_launches"], rec["backward_pull_launches"]):
            for k in total:
                total[k] += launches[k]
        if not (rec["forward_launches"] == {k: blocks if k in FORWARD else 0 for k in total}
                and _model_kernels(rec["backward_pull_launches"])
                == dict.fromkeys(FORWARD + BACKWARD, blocks)
                and rec["plain_launches"] == 0 and rec["finite"] and rec["bf16"]["finite"]
                and rec["logits_shape"] == [BATCH, 1000]
                and rec["logit_rel_err"] <= MODEL_REL_TOL
                and rec["feat_rel_err"] <= MODEL_REL_TOL
                and rec["grad_l2_rel_err"] <= GRAD_L2_TOL):
            failures.append(name)
    if failures:
        raise RuntimeError(f"classifier rows failed: {failures}")
    return total


# ----------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp-cards", action="store_true",
                    help="only the build and the dp phase, its ranks NCCL, one a visible "
                    "card (a host of several cards)")
    ap.add_argument("--cp-only", action="store_true",
                    help="only the build and the cp phase (with --dp-cards: the cp phase's "
                    "NCCL ranks alone, without the dp phase)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
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
    if args.dp_cards or args.cp_only:
        with no_tf32():
            if args.dp_cards and not args.cp_only:
                timed("dp", phase_dp, args.seed, torch.cuda.device_count(), "nccl")
            if args.dp_cards:
                timed("cp_cards", phase_cp_cards, args.seed)
            else:
                emit({"phase": "cp_launches", "launches_by_path": timed("cp", phase_cp, args.seed)})
        emit({"phase": "done", "seconds": time.perf_counter() - t0, "by_phase": seconds})
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    with no_tf32():
        summary = timed("kernels", phase_kernels, args.seed)
        summary.update(timed("backward", phase_backward, args.seed))
        summary["dropout"] = timed("dropout", phase_dropout, args.seed)
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
        cp_launches = timed("cp", phase_cp, args.seed)
        zoo_launches = timed("zoo", phase_zoo, args.seed)
        classifier_launches = timed("classifiers", phase_classifiers, args.seed, summary)
    paths = {"serving B=16 fp32": serving_launches, "train step fp32": step_launches,
             "Trainer.fit": trainer["launches"], "exported program B=16 fp32": export_launches,
             "remat train step fp32": remat_launches,
             f"dp train step fp32, rank 0 of {DP_WORLD}": dp_launches,
             **cp_launches,
             "zoo": zoo_launches,
             "classifiers": classifier_launches}
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
    s = summary["dropout"]
    line.append({"name": "dropout", "route": "cuda", "source": "mdvit_tpu_torch/csrc/dropout.cu",
                 "replaces": "none: XLA fuses mdvit_tpu/data/augment.py:fast_uniform into "
                             "its consumer",
                 "launches": trainer["launches"]["dropout"], "max_abs_err": s["max_abs_err"],
                 **s["float32"], "bound_by": "bytes" if s["bound_by"] == {"bytes"} else "operations",
                 "per": f"one fp32 train step, D*B=16 at 256 ({s['calls']} calls)",
                 "launches_per": "Trainer.fit, 2 epochs of 8 steps and 8 eval "
                                 "batches, bf16, D*B=16 at 256",
                 "launches_by_path": {path: n.get("dropout") for path, n in paths.items()},
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
