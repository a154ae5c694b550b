"""Traffic kind "cp_train": the system's context-parallel train step over
``ranks`` processes, each image's rows split over them, fed back to back.

The harness's process is rank 0, on ``cuda:0``. Set-up spawns ranks 1 … n−1
(``spawn`` start method), on cards 1 … n−1, joined in one process group
(NCCL on cards, gloo on the CPU) with a timeout; each rank builds the system
under test through its entry points (``models.registry``,
``train.optim.build_optimizer``, ``parallel.context.make_context_mesh`` and
``make_context_parallel_train_step`` over a ctx group of every rank), loads
the benchmark's weights from the seed and puts the same per-domain uint8
stores on its card. Every rank gathers (``data.loader.gather_batch``) and
augments (``data.augment.augment_batch``) the same global batch from the same
seed, in the benchmark's ``portbench.data`` span, and passes it whole to the
step, which runs the rank's rows: the step's contract. The first
``compared_steps`` steps are compared; then ``WARMUP_STEPS`` steps, timed on
rank 0, set the pace.

A window's steps are fixed before it starts: ``steps``, or enough at the
warm-up's pace to fill ``seconds``. Rank 0 sends the count to every rank;
every rank runs them, synchronizes its card and reports, and the window ends
when rank 0 has every report. A rank that fails ends the run: a worker's
error or exit makes rank 0 kill the others and exit non-zero (a watch thread,
even while rank 0 waits in a collective); rank 0's error kills the workers;
a worker whose parent is gone exits; a collective that waits past the
group's timeout aborts its process.

The check (after every rank freed its state): the plain reference
(``portbench.reference.cp``) takes the same weights, stores and index rows,
draws its dropout and augmentation as the ranks do, and runs the compared
steps unsharded, blocked over depth, on card 0; compared by
``traffic.train.compare`` (each step's loss, the first gradient's norm leaf
by leaf, each leaf's change), and ``ranks_apart``: the largest |parameter −
rank 0's| over every rank after the compared steps.
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import math
import os
import socket
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from portbench import data, system, trace, weights
from portbench.reference import cp as ref_cp
from portbench.reference import train as ref_train
from portbench.traffic.train import compare, leaf_norms

WARMUP_STEPS = 3
GROUP_TIMEOUT_S = 180      # a collective waiting longer aborts its process
JOIN_TIMEOUT_S = 60        # a release taking longer ends the run


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: card ``rank``, or the CPU."""
    device = torch.device(device)
    return torch.device("cuda", rank) if device.type == "cuda" else device


def join_group(rank: int, mix: dict, port: int, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
        # a collective past the timeout tears its process down
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=mix["ranks"],
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def optimizer_config(cfg: dict):
    """The system's config of the configuration's AdamW and StepLR."""
    from mdvit_tpu_torch.utils.pieces import DotDict

    o = cfg["optimizer"]
    return DotDict({"train": {"optimizer": {"mode": "adamw", "adamw": {
        "lr": o["lr"], "betas": list(o["betas"]), "eps": o["eps"],
        "weight_decay": o["weight_decay"]}},
        "scheduler": {"step_size": o["step_size"], "gamma": o["gamma"]}}})


class Rank:
    """One rank's system under test: the model, its optimizer, the context-
    parallel step over every rank, the stores and the generators."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, spans):
        from mdvit_tpu_torch.parallel.context import (make_context_mesh,
                                                      make_context_parallel_train_step)
        from mdvit_tpu_torch.train.optim import build_optimizer

        self.device, self.spans = device, spans
        d, b, n = cfg["num_domains"], mix["per_domain_batch"], mix["per_domain_store"]
        self.model = system.build(cfg, device)
        state = weights.from_seed(cfg, seed, device)
        self.model.load_state_dict(state)
        self.state = {k: v.cpu() for k, v in state.items()} if dist.get_rank() == 0 else None
        del state
        self.optimizer, _ = build_optimizer(self.model, n // b, optimizer_config(cfg))
        self.step = make_context_parallel_train_step(self.model, self.optimizer,
                                                     make_context_mesh(mix["ranks"]))
        self.stores = data.stores(seed, d, n, cfg["img_size"], device)
        self.epochs = data.Epochs(seed, d, n, b, device)
        step_seed = data.sub_seed(seed, data.STEP)
        self.gen = torch.Generator().manual_seed(step_seed)
        self.aug_gen = torch.Generator(device=device).manual_seed(step_seed)

    def one(self) -> torch.Tensor:
        """One step on the next global batch: its loss (on the device)."""
        from mdvit_tpu_torch.data.augment import augment_batch
        from mdvit_tpu_torch.data.loader import gather_batch

        with self.spans("data"):
            x, m, onehot = gather_batch(*self.stores, self.epochs.next())
            x, y = augment_batch(self.aug_gen, x, m)
        with self.spans("step"):
            return self.step(x, y, onehot, self.gen)

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.one()
        with self.spans("sync"):
            data.sync(self.device)

    def compared(self, steps: int) -> dict:
        """The record of the first ``steps`` steps (each loss, the first
        gradient's and each leaf's change's norms) and ``ranks_apart``."""
        named = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        losses = []
        for k in range(steps):
            losses.append({"loss": float(self.one())})
            if k == 0:
                grad = leaf_norms({n: p.grad for n, p in named.items()})
        update = leaf_norms({n: p - start[n] for n, p in named.items()})
        del start
        flat = torch.cat([p.detach().reshape(-1) for p in named.values()])
        first = flat.clone()
        dist.broadcast(first, src=0)
        apart = (flat - first).abs().max().reshape(1)
        dist.all_reduce(apart, op=dist.ReduceOp.MAX)
        return {"losses": losses, "grad": grad, "update": update,
                "ranks_apart": float(apart)}

    def pace(self) -> float:
        """Seconds a step over ``WARMUP_STEPS`` steps after a synchronize."""
        data.sync(self.device)
        t0 = time.perf_counter()
        self.run(WARMUP_STEPS)
        return (time.perf_counter() - t0) / WARMUP_STEPS


def end_group() -> None:
    """Every rank's end of the group, all ranks together: NCCL's teardown
    waits for the ranks that have not begun theirs (four cards, workers
    destroying while rank 0 waited for their reports, hung past a run's
    time)."""
    dist.barrier()
    dist.destroy_process_group()


def end_rank() -> None:
    """A worker's end once rank 0 has its report: the process exits at once."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _watch_parent(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def worker(rank: int, cfg: dict, mix: dict, seed: int, port: int, device, conn,
           parent: int) -> None:
    """Rank ``rank`` (≥ 1): set-up and the compared and warm-up steps, then
    the commands of rank 0 (``("steps", n)``, ``("release",)``); any error
    exits the process non-zero."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    try:
        device = rank_device(device, rank)
        if device.type != "cuda":
            torch.set_num_threads(1)
        join_group(rank, mix, port, device)
        me = Rank(cfg, mix, seed, device, trace.Spans(False))
        me.compared(mix["compared_steps"])
        me.pace()
        conn.send("ready")
        while True:
            cmd = conn.recv()
            if cmd[0] == "steps":
                me.run(cmd[1])
                conn.send("done")
            else:
                del me
                gc.collect()
                end_group()
                conn.send("released")
                end_rank()
    except BaseException:  # noqa: BLE001  (any failure: report, exit non-zero)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Traffic:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        self.cfg, self.mix, self.seed, self.spans = cfg, mix, seed, spans
        self.device = torch.device(device)
        self.d, self.b = cfg["num_domains"], mix["per_domain_batch"]
        self.procs, self.conns, self.released = [], [], False

    # ---------------------------------------------------------- the workers

    def _watch(self) -> None:
        """Kill every rank and exit once a worker has failed (a worker exits 0
        only once released)."""
        while not self.released:
            if any(p.exitcode not in (None, 0) for p in self.procs) and not self.released:
                print("portbench.cp_train: a rank exited; ending the run", file=sys.stderr,
                      flush=True)
                self._kill()
                os._exit(1)
            time.sleep(0.5)

    def _abandon(self) -> None:
        print("portbench.cp_train: the ranks did not end their group in time; ending the run",
              file=sys.stderr, flush=True)
        self._kill()
        os._exit(1)

    def _kill(self) -> None:
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
        for p in self.procs:
            p.join(timeout=JOIN_TIMEOUT_S)

    def _expect(self, reply: str) -> None:
        for conn in self.conns:
            if conn.recv() != reply:
                raise RuntimeError(f"a rank did not reply {reply!r}")

    @contextlib.contextmanager
    def _guarded(self):
        """Rank 0's work: on an error, the workers are killed first."""
        try:
            yield
        except BaseException:
            self.released = True
            self._kill()
            if dist.is_initialized() and dist.get_backend() == "gloo":
                dist.destroy_process_group()  # an NCCL group may be stuck: the exit ends it
            raise

    # ---------------------------------------------------------- the cell

    def setup(self) -> None:
        mix, ctx = self.mix, mp.get_context("spawn")
        if self.device.type == "cuda":
            from mdvit_tpu_torch.ops import kernels

            kernels.build()  # once, before the ranks load the libraries
        port = free_port()
        with self._guarded():
            for rank in range(1, mix["ranks"]):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=worker, daemon=True,
                                args=(rank, self.cfg, mix, self.seed, port, str(self.device),
                                      theirs, os.getpid()))
                p.start()
                self.procs.append(p)
                self.conns.append(mine)
            threading.Thread(target=self._watch, daemon=True).start()
            device = rank_device(self.device, 0)
            join_group(0, mix, port, device)
            self.me = Rank(self.cfg, mix, self.seed, device, self.spans)
            self.state, self.stores = self.me.state, self.me.stores
            self.record = self.me.compared(mix["compared_steps"])
            self.step_s = self.me.pace()
            self._expect("ready")

    def window(self, seconds: float | None = None, steps: int | None = None) -> dict:
        """``steps`` steps on every rank, or as many as fill ``seconds`` at the
        warm-up's pace; ends when every rank has synchronized its card."""
        n = steps if steps is not None else max(1, math.ceil(seconds / self.step_s))
        with self._guarded():
            t0 = time.perf_counter()
            for conn in self.conns:
                conn.send(("steps", n))
            self.me.run(n)
            self._expect("done")
            elapsed = time.perf_counter() - t0
        return {"work": n, "images": n * self.d * self.b, "seconds": elapsed}

    def flops(self) -> float:
        """Model FLOPs of one rank's share of a step (the whole step's over
        the ranks)."""
        from portbench.flops import step_flops
        return step_flops(self.cfg, self.d, self.b, self.cfg["img_size"]) / self.mix["ranks"]

    def release(self) -> None:
        """Every rank frees its state and ends the group, together; the
        workers exit, rank 0 keeps its stores for the check."""
        deadline = threading.Timer(JOIN_TIMEOUT_S, self._abandon)
        deadline.daemon = True
        deadline.start()
        try:
            with self._guarded():
                for conn in self.conns:
                    conn.send(("release",))
                del self.me
                gc.collect()
                end_group()
                self._expect("released")
                self.released = True
                for p in self.procs:
                    p.join(timeout=JOIN_TIMEOUT_S)
        finally:
            deadline.cancel()
        if any(p.exitcode != 0 for p in self.procs):
            raise RuntimeError("a rank did not end cleanly")

    def reference(self, tf32: bool = False, fault: str | None = None) -> dict:
        """The reference's record of this run's compared steps."""
        return reference_record(self.cfg, self.mix, self.state, self.stores, self.seed,
                                self.device, tf32, fault)

    def check(self, ref: dict | None = None) -> dict:
        """The compared steps against the reference's (``ref``, or computed),
        and how far the ranks' parameters are apart."""
        numbers = compare(self.record, ref or self.reference(), self.mix["excluded_below"])
        return {**numbers, "ranks_apart": self.record["ranks_apart"]}

    @staticmethod
    def end_to_end(result: dict) -> dict:
        return {"train_img_per_s": result["images"] / result["seconds"]}


def reference_record(cfg: dict, mix: dict, state: dict, stores, seed: int, device,
                     tf32: bool = False, fault: str | None = None,
                     blocked: bool = True) -> dict:
    """The plain reference's record of the compared steps, in fp32 with TF32
    off (``tf32``: on, the control); ``fault``: a planted fault
    (``reference.cp.Step.grads``)."""
    ref_train.set_precision(tf32)
    try:
        with torch.device(device):
            model = ref_train.build(cfg)
        model.load_state_dict(state)
        step = ref_cp.Step(model, cfg, mix["per_domain_store"] // mix["per_domain_batch"],
                           data.sub_seed(seed, data.STEP), mix["ranks"], blocked)
        epochs = data.Epochs(seed, cfg["num_domains"], mix["per_domain_store"],
                             mix["per_domain_batch"], device)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        record = {"losses": []}
        for k in range(mix["compared_steps"]):
            loss, grads = step(*stores, epochs.next(), fault)
            record["losses"].append({"loss": loss})
            if k == 0:
                record["grad"] = leaf_norms(dict(zip((n for n, _ in step.named), grads)))
        record["update"] = leaf_norms({n: p - start[n] for n, p in model.named_parameters()})
        return record
    finally:
        ref_train.set_precision(False)
