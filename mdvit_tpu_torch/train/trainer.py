"""The multi-domain training and eval driver, the port of
``mdvit_tpu/train/trainer.py``.

All domains in one train step with on-device augmentation, data resident on
the card, metrics on the card and fetched once per epoch (train) or per
dataset (eval). The reference's protocol: an epoch is max domain length over
the batch size, the best model by mean val IoU, val on the test split (the
reference's own choice), per-domain scalars, ``test_results.csv`` with a
Total row, ``debug`` one-batch mode. ``last.pt`` holds the full train state
for resume, ``best_meta.json`` the best IoU and epoch.

Data parallelism (``parallel.mesh``, JAX's mesh rule): the data-parallel
group is the first n ranks of ``torch.distributed``'s world, n the largest
divisor of D·B at most the world and ``tpu.mesh.data``; each rank trains and
evaluates on its rows of every batch (``train.steps``), and every rank holds
the same model. Rank 0 alone writes ``exp_config.yml``, the scalars,
``best.pt``, ``last.pt``, ``best_meta.json``, ``test_results.csv`` and the
profile, and prints; every rank reads ``last.pt`` on resume. At n = 1 there
is no group and no collective.

The port trains the models of the paper's comparisons: MDViT
(any debranch, with or without the Sup gate), MDViT_DSN, BASE (± Sup),
BASE_DSN, BASE_DASE, BASE_USE, and the segmentation comparators SwinUnet,
SwinUNETR, UTNet, TransFuse_S, TransFuse_S_adapt and TransFuse_L; a model
whose name starts with MDViT trains with the MKD objective, TransFuse with
its deep supervision, the others with the single one. ``pretrained_folder``
grafts converted ImageNet backbones into a TransFuse
(``train.pretrained``). A classifier (Swin, MPViT, CoaT: no segmentation
output) raises ``ValueError``, as JAX's trainer cannot train one either.
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Any

import numpy as np
import torch

from mdvit_tpu_torch.config import check_supported, save_config
from mdvit_tpu_torch.data.datasets import build_domain_data
from mdvit_tpu_torch.data.loader import (DeviceDomainStore, EvalSplitStore,
                                         RoundRobinSampler, eval_batches,
                                         eval_index_batches)
from mdvit_tpu_torch.device import resolve_device
from mdvit_tpu_torch.models.registry import build_model, require_segmenter
from mdvit_tpu_torch.parallel.mesh import Mesh, local_device, make_mesh
from mdvit_tpu_torch.train import checkpoints as ckpt
from mdvit_tpu_torch.train.optim import build_optimizer, steplr
from mdvit_tpu_torch.train.pretrained import apply_pretrained
from mdvit_tpu_torch.train.steps import counts_to_metrics, make_eval_step, make_train_step
from mdvit_tpu_torch.utils.logging import ScalarLogger

RESULT_COLUMNS = ("Name", "loss", "Di_score", "IOU")


def results_table(names, results) -> list[dict[str, Any]]:
    """``test_results`` rows plus the Total row: loss summed, Dice and IoU
    averaged over the datasets (reference ``multi_train_MDViT.py:404-415``)."""
    rows = [{"Name": n, "loss": float(results[n]["loss"]),
             "Di_score": float(results[n]["dice"]), "IOU": float(results[n]["iou"])}
            for n in names]
    rows.append({"Name": "Total", "loss": float(np.sum([r["loss"] for r in rows])),
                 "Di_score": float(np.mean([r["Di_score"] for r in rows])),
                 "IOU": float(np.mean([r["IOU"] for r in rows]))})
    return rows


def write_results_csv(path: str, rows: list[dict[str, Any]]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=RESULT_COLUMNS, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def format_results(rows: list[dict[str, Any]]) -> str:
    lines = ["{:<10} {:>12} {:>12} {:>12}".format(*RESULT_COLUMNS)]
    lines += ["{:<10} {:>12.6f} {:>12.6f} {:>12.6f}".format(
        r["Name"], r["loss"], r["Di_score"], r["IOU"]) for r in rows]
    return "\n".join(lines)


def fetch(tree: Any) -> Any:
    """``tree`` (nested dicts and lists of device tensors) with every tensor
    as a numpy array, through ONE device-to-host copy."""
    leaves: list[torch.Tensor] = []

    def collect(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                collect(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().float().reshape(-1) for t in leaves]).cpu().numpy()
    parts, pos = [], 0
    for t in leaves:
        parts.append(flat[pos:pos + t.numel()].reshape(tuple(t.shape)))
        pos += t.numel()
    it = iter(parts)

    def rebuild(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return t

    return rebuild(tree)


def _is_mkd_model(name: str) -> bool:
    return name.startswith("MDViT")


def build_model_from_config(config, device: torch.device) -> torch.nn.Module:
    """The registry model ``config.model`` (``trainer.py:build_model_from_config``):
    ``data.img_size``, ``model_adapt.num_domains`` and ``adapt_method``,
    ``tpu.compute_dtype``, ``seed`` and ``model_kwargs`` (widths and depths
    for tiny test models, MDViT's ``decoder_name``)."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in (config.get("model_kwargs") or {}).items()}
    dtype = torch.bfloat16 if str(config.tpu.compute_dtype) == "bfloat16" else torch.float32
    return build_model(config.model, img_size=int(config.data.img_size),
                       num_domains=int(config.model_adapt.num_domains),
                       adapt_method=config.model_adapt.adapt_method, dtype=dtype,
                       device=device, seed=int(config.get("seed", 42)), **kw)


def data_parallel_mesh(config) -> Mesh:
    """The data-parallel group of this process for ``config``: the world of
    ``torch.distributed`` (one process when it is not initialised), capped by
    ``tpu.mesh.data`` and shrunk to a divisor of D·B. Every rank of the world
    calls it."""
    cap = int((config.tpu.get("mesh") or {}).get("data", -1) or -1)
    return make_mesh(cap, len(config.data.name) * int(config.train.batch_size))


class Trainer:
    def __init__(self, config, exp_dir: str, mesh: Mesh | None = None):
        """``mesh``: this process's data-parallel group
        (``data_parallel_mesh(config)`` when None); a rank outside it may not
        build a Trainer."""
        check_supported(config)
        require_segmenter(config.model)
        self.config = config
        self.exp_dir = exp_dir
        self.mesh = data_parallel_mesh(config) if mesh is None else mesh
        if not self.mesh.member:
            raise ValueError(f"rank {self.mesh.rank} is outside the data-parallel "
                             f"group of {self.mesh.size}")
        self.is_main = self.mesh.rank == 0
        self.say = print if self.is_main else (lambda *args, **kw: None)
        os.makedirs(exp_dir, exist_ok=True)
        if self.is_main:
            save_config(config, os.path.join(exp_dir, "exp_config.yml"))
        self.logger = ScalarLogger(exp_dir if self.is_main else None)
        self.device = resolve_device(local_device(config.get("device")))
        self.model = build_model_from_config(config, self.device)
        if config.get("pretrained_folder"):  # TransFuse starts from ImageNet backbones
            report = apply_pretrained(self.model, config.model, str(config.pretrained_folder))
            if report:
                self.say(report)
        self.mkd = _is_mkd_model(config.model)

        self.names = list(config.data.name)
        self.num_domains = len(self.names)
        if self.mesh.size > 1:
            self.say(f"data-parallel group of {self.mesh.size} ranks (global batch "
                     f"{self.num_domains * int(config.train.batch_size)})")
        syn = config.data.get("synthetic_sizes")
        self.data = build_domain_data(
            self.names, config.data.data_folder, int(config.data.img_size),
            k_fold=str(config.data.k_fold), split_ratio=tuple(config.data.split_ratio),
            synthetic=bool(config.data.get("synthetic", False)),
            synthetic_sizes={k: tuple(v) for k, v in syn.items()} if syn else None)
        for n in self.names:
            self.say(f"{n} has {len(self.data[n]['train'])} training samples")

        self.batch_size = int(config.train.batch_size)
        self.store = DeviceDomainStore([self.data[n]["train"] for n in self.names],
                                       self.device)
        self.sampler = RoundRobinSampler(self.store.sizes, self.batch_size,
                                         seed=int(config.get("seed", 42)))
        self.steps_per_epoch = (int(config.train.num_iters) if config.train.num_iters
                                else self.sampler.steps_per_epoch)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.say(f"{n_params / 1e6}M total trainable parameters")

        self.optimizer, self.scheduler = build_optimizer(self.model, self.steps_per_epoch,
                                                         config)
        device_augment = bool(config.tpu.get("device_augment", True))
        if bool(config.data.train_aug) and not device_augment:
            raise ValueError(
                "data.train_aug=True requires tpu.device_augment=True (augmentation "
                "runs inside the train step; set data.train_aug=False to train "
                "unaugmented)")
        self.train_step = make_train_step(
            self.model, self.optimizer, self.scheduler, self.num_domains,
            alpha=float(config.train.get("alpha", 0.5)),
            det_sup=bool(config.train.get("det_sup", True)), mkd=self.mkd,
            seed=int(config.get("seed", 42)),
            device_augment=device_augment and bool(config.data.train_aug),
            remat=bool(config.tpu.get("remat", False)), group=self.mesh.group)
        self.device_eval = bool(config.tpu.get("device_eval", True))
        self._eval_stores: dict[str, EvalSplitStore] = {}
        self.eval_step = make_eval_step(self.model, mkd=self.mkd,
                                        from_store=self.device_eval, group=self.mesh.group)
        self.step = 0
        self.max_iou = 0.0
        self.best_epoch = 0
        self.start_epoch = 0
        self.writer: ckpt.CheckpointWriter | None = None
        self.history: list[dict] = []  # per epoch: train and eval seconds, img/s

    # ------------------------------------------------------------------
    def _eval_store(self, split: str) -> EvalSplitStore:
        """One eval split on the card, uploaded at first use."""
        if split not in self._eval_stores:
            self._eval_stores[split] = EvalSplitStore(
                [self.data[n][split] for n in self.names], self.device)
        return self._eval_stores[split]

    # ------------------------------------------------------------------
    def full_state(self, epoch: int) -> dict:
        """Everything a resume needs (``last.pt``)."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "generator": self.train_step.generator.get_state(),
                "aug_generator": self.train_step.aug_generator.get_state(),
                "step": self.step, "epoch": epoch, "max_iou": self.max_iou}

    def maybe_resume(self) -> None:
        """Every rank loads ``last.pt``; they wait for each other before rank
        0's writer, made in ``fit``, may promote a pending checkpoint."""
        restored = ckpt.try_load_last(self.exp_dir)
        self.mesh.barrier()
        if restored is None:
            return
        self.model.load_state_dict(restored["model"])
        self.optimizer.load_state_dict(restored["optimizer"])
        self.scheduler.load_state_dict(restored["scheduler"])
        self.train_step.generator.set_state(restored["generator"])
        self.train_step.aug_generator.set_state(restored["aug_generator"])
        self.step = int(restored["step"])
        self.start_epoch = int(restored["epoch"]) + 1
        self.max_iou = float(restored["max_iou"])
        # `last` is saved every save_last_every epochs but `best` every epoch
        # it improves: take the sidecar's max_iou, so a resumed run never
        # overwrites a better `best` with a worse model
        meta = self._read_best_meta()
        if meta is not None and float(meta.get("max_iou", 0.0)) > self.max_iou:
            self.max_iou = float(meta["max_iou"])
            self.best_epoch = int(meta.get("best_epoch", self.best_epoch))
        self.say(f"resumed from epoch {self.start_epoch - 1}")

    def _best_meta_path(self) -> str:
        return os.path.join(self.exp_dir, "best_meta.json")

    def _read_best_meta(self):
        try:
            with open(self._best_meta_path()) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    def _write_best_meta(self) -> None:
        tmp = self._best_meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"max_iou": self.max_iou, "best_epoch": self.best_epoch}, f)
        os.replace(tmp, self._best_meta_path())

    # ------------------------------------------------------------------
    def _profiler(self, epoch: int):
        steps = int(self.config.tpu.get("profile_steps", 0) or 0)
        if steps <= 0 or epoch != self.start_epoch or not self.is_main:
            return None, 0
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts), steps

    def train_epoch(self, epoch: int) -> dict:
        """One epoch: per-step per-domain scalars and epoch means over all
        steps (the reference's AvgMeter), from ONE host fetch at the end."""
        t0 = time.time()
        pending = []
        step0 = self.step
        prof, profile_steps = self._profiler(epoch)
        if prof is not None:
            prof.__enter__()
        for it in range(self.steps_per_epoch):
            rows = self.sampler.next_batch().astype(np.int64)
            indices = torch.from_numpy(rows).to(self.device)
            pending.append(self.train_step(self.store.images, self.store.masks, indices))
            if prof is not None and it + 1 >= profile_steps:
                self._stop_profiler(prof, profile_steps)
                prof = None
            if self.config.debug:
                break
        if prof is not None:
            self._stop_profiler(prof, profile_steps)
        steps = fetch(pending)
        dt = time.time() - t0
        self.step += len(steps)

        for k, m in enumerate(steps):
            gstep = step0 + k + 1
            for i, n in enumerate(self.names):
                self.logger.add_scalar(f"Train/{n}/loss", m["loss_per_domain"][i], gstep)
                self.logger.add_scalar(f"Train/{n}/IOU", m["iou_per_domain"][i], gstep)
                if self.mkd:
                    self.logger.add_scalar(f"Train/{n}/auxloss",
                                           m["aux_loss_per_domain"][i], gstep)
                    self.logger.add_scalar(f"Train/{n}/ktloss",
                                           m["kt_loss_per_domain"][i], gstep)

        def mean_of(key):
            return float(np.mean([m[key] for m in steps]))

        epoch_mean = {"loss": mean_of("loss"), "iou": mean_of("iou_per_domain"),
                      "dice": mean_of("dice_per_domain")}
        gstep = step0 + len(steps)
        # the rate the epoch's last update used (update gstep - 1)
        self.logger.add_scalar("Train/lr", steplr(self.config, self.steps_per_epoch,
                                                  max(gstep - 1, 0)), epoch)
        self.logger.add_scalar("Train/Average/sum_loss", epoch_mean["loss"], gstep)
        self.logger.add_scalar("Train/Average/IOU", epoch_mean["iou"], gstep)
        if self.mkd:
            for key in ("aux_loss", "kt_loss"):
                epoch_mean[key] = mean_of(key)
                self.logger.add_scalar(f"Train/Average/{key}", epoch_mean[key], gstep)
        img_per_s = len(steps) * self.num_domains * self.batch_size / max(dt, 1e-9)
        self.say(f"Epoch {epoch}, steps {len(steps)} || sum_loss: {epoch_mean['loss']:.4f}, "
                 f"Avg IOU: {epoch_mean['iou']:.4f} || {dt:.1f}s ({img_per_s:.1f} img/s)")
        self.history.append({"epoch": epoch, "steps": len(steps), "train_seconds": dt,
                             "img_per_s": img_per_s})
        return epoch_mean

    def _stop_profiler(self, prof, steps: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        out = os.path.join(self.exp_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        print(f"profiler trace ({steps} steps) written to {out}")

    # ------------------------------------------------------------------
    def evaluate(self, split: str = "test", epoch: int | None = None) -> dict:
        """Per-domain batch-weighted loss, dice and IoU (reference protocol);
        with MKD every batch goes to its domain's debranch too. Under data
        parallelism each batch of ``test.batch_size`` is padded to a multiple
        of the ranks and split over them: the grouping, and so the metric,
        stays the single process's (``mdvit_tpu/train/trainer.py:421-431``)."""
        results = {}
        eval_bs = int(self.config.test.batch_size)
        pad_to = -(-eval_bs // self.mesh.size) * self.mesh.size
        for di, n in enumerate(self.names):
            onehot = torch.zeros((pad_to, self.num_domains), device=self.device)
            onehot[:, di] = 1.0
            if self.device_eval:
                store = self._eval_store(split)
                off, n_dom = store.domain(di)
                batches = ((store.images, store.masks,
                            torch.from_numpy(idx.astype(np.int64)).to(self.device), valid)
                           for idx, valid in eval_index_batches(off, n_dom, eval_bs, pad_to))
            else:
                batches = ((torch.from_numpy(imgs).to(self.device),
                            torch.from_numpy(msks).to(self.device), None, valid)
                           for imgs, msks, valid in eval_batches(self.data[n][split], eval_bs,
                                                                 pad_to))
            pending, valids = [], []
            for imgs, msks, idx, valid in batches:
                pending.append(self.eval_step(imgs, msks, onehot, valid, domain=di,
                                              indices=idx))
                valids.append(valid)
                if self.config.debug:
                    break
            loss_sum = dice_sum = iou_sum = aux_dice_sum = aux_iou_sum = 0.0
            for out, valid in zip(fetch(pending), valids):
                dice, iou = counts_to_metrics(out["primary"])
                adice, aiou = counts_to_metrics(out["aux"]) if self.mkd else (0.0, 0.0)
                loss_sum += float(out["loss"]) * valid
                dice_sum += dice * valid
                iou_sum += iou * valid
                aux_dice_sum += adice * valid
                aux_iou_sum += aiou * valid
            num = sum(valids)
            results[n] = {"loss": loss_sum / num, "dice": dice_sum / num,
                          "iou": iou_sum / num, "aux_dice": aux_dice_sum / num,
                          "aux_iou": aux_iou_sum / num}
            if epoch is not None:
                self.logger.add_scalar(f"Val/{n}/loss", results[n]["loss"], epoch)
                self.logger.add_scalar(f"Val/{n}/Di_score", results[n]["dice"], epoch)
                self.logger.add_scalar(f"Val/{n}/IOU", results[n]["iou"], epoch)
        return results

    # ------------------------------------------------------------------
    def fit(self) -> None:
        epochs = int(self.config.train.num_epochs)
        writer = self.writer = ckpt.CheckpointWriter(self.exp_dir) if self.is_main else None
        if self.start_epoch == 0 and writer is not None:
            # initial weights, so test() always has a checkpoint (reference
            # multi_train_MDViT.py:114)
            writer.save_best(self.model)
        every = int(self.config.train.get("save_last_every", 5) or 1)
        for epoch in range(self.start_epoch, epochs):
            self.train_epoch(epoch)
            t0 = time.time()
            val = self.evaluate("test", epoch=epoch)
            self.history[-1]["eval_seconds"] = time.time() - t0
            avg_iou = float(np.mean([v["iou"] for v in val.values()]))
            avg_dice = float(np.mean([v["dice"] for v in val.values()]))
            self.logger.add_scalar("Val/Average/IOU", avg_iou, epoch)
            self.logger.add_scalar("Val/Average/Di_score", avg_dice, epoch)
            self.say(f"Epoch {epoch}, Validation || Avg Dice: {avg_dice:.4f}, "
                     f"Avg IOU: {avg_iou:.4f}")
            # every rank holds the same results, so every rank decides alike
            if avg_iou > self.max_iou:
                self.max_iou = avg_iou
                self.best_epoch = epoch
                if writer is not None:
                    writer.save_best(self.model)
                    self._write_best_meta()
                self.say(f"New best epoch {epoch}!===============================")
            if writer is not None and ((epoch + 1) % every == 0 or epoch == epochs - 1):
                writer.save_last(self.full_state(epoch))
            self.logger.flush()
            if self.config.debug:
                break
        if writer is not None:
            writer.close()
        self.mesh.barrier()  # best.pt and last.pt complete before any rank reads them
        self.say("Complete training ------------------------------------------\n"
                 f"The best epoch is {self.best_epoch}")

    # ------------------------------------------------------------------
    def test(self, model_dir: str | None = None) -> list[dict[str, Any]]:
        """Load the best checkpoint (or ``model_dir``: an experiment dir or a
        checkpoint file), evaluate the test split, write test_results.csv
        (reference ``test()``)."""
        if model_dir is None:
            try:
                blob = ckpt.load_best(self.exp_dir)
            except FileNotFoundError:
                blob = ckpt.try_load_last(self.exp_dir)
                if blob is None:
                    raise
                self.say("best checkpoint missing; testing the last checkpoint")
        elif os.path.isdir(model_dir):
            blob = ckpt.load_best(model_dir)
        else:
            blob = ckpt.load(model_dir)
        self.model.load_state_dict(blob["model"])
        rows = results_table(self.names, self.evaluate("test"))
        if self.is_main:
            write_results_csv(os.path.join(self.exp_dir, "test_results.csv"), rows)
        self.say(format_results(rows))
        return rows
