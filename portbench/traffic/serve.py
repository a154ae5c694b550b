"""Traffic kind "serve": one caller segments an archive, a batch a call,
keeping the card fed: up to the mix's ``ahead`` calls in flight.

Set-up builds the system's model from its registry, loads the benchmark's
weights (their BatchNorm statistics the moments of a calibration batch, as
a trained model's hold them), wraps it in the system's serving entry
``predict.make_forward``, makes a pool of distinct batches on the card and
runs a short window over the pool, which warms every shape and path the
window takes. Each call issues the forward and the copy of its
probability maps into one of ``ahead`` pinned host buffers, used in turn;
before a buffer is used again the caller waits until the call that last
filled it has landed. So a stall of the host's is covered by the calls
still queued, up to ``ahead`` of them, as an archive job that streams its
results keeps the card busy. The window cycles through the pool while its
seconds last, then issues nothing more, waits for every call it issued
and reads the clock after that wait: all of those calls count, over all
of that time.

A call's service time runs from when the card could start it (its issue,
or the landing of the call before, whichever is later) until its maps are
in host memory; a host stall that leaves the card without work lengthens
it. On the card the landings are read from events timed on the device's
clock, which starts beside the host's at the window's start.

The check keeps the maps of a sample of the window's calls, drawn from the
seed by reservoir sampling (a kept buffer is swapped out of the ring,
nothing is copied in the window), and compares them, once every call has
landed, with the plain reference's maps of the same batches: the largest
gap of a probability.
"""
from __future__ import annotations

import random
import time

import torch

from portbench import data, system, weights
from portbench.reference import rng
from portbench.reference import train as ref_train


def p95(latencies: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(latencies)
    return s[max(0, -(-95 * len(s) // 100) - 1)]


def reference_maps(cfg: dict, state: dict, batches, tf32: bool = False) -> list:
    """The plain reference's probability maps of ``batches`` ((images,
    one-hot) pairs) in fp32 with TF32 off (``tf32``: on, the control)."""
    ref_train.set_precision(tf32)
    with torch.device(batches[0][0].device):
        model = ref_train.build(cfg)
    model.load_state_dict(state)
    return [ref_train.serve(model, x, oh).cpu() for x, oh in batches]


class Traffic:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        self.cfg, self.mix, self.seed, self.device, self.spans = cfg, mix, seed, device, spans
        self.batch = mix["batch"]

    def setup(self) -> None:
        from mdvit_tpu_torch.predict import make_forward

        cfg, mix, dev = self.cfg, self.mix, self.device
        model = system.build(cfg, dev)
        with torch.device(dev):
            calib = ref_train.build(cfg)
        calib.load_state_dict(weights.from_seed(cfg, self.seed, dev))
        (x, oh), = data.pool(self.seed, 1, mix["calibration_batch"], cfg["img_size"],
                             cfg["num_domains"], dev, data.CALIBRATION)
        state = weights.calibrated(calib, x, oh, rng.normalize)
        del calib, x, oh
        model.load_state_dict(state)
        self.state = {k: v.cpu() for k, v in state.items()}
        del state
        self.model = model
        self.forward = make_forward(model)
        self.pool = data.pool(self.seed, mix["pool"], self.batch, cfg["img_size"],
                              cfg["num_domains"], dev)
        shape = (self.batch, cfg["img_size"], cfg["img_size"])
        self.cuda = torch.device(dev).type == "cuda"
        self.ring = [torch.empty(shape, pin_memory=self.cuda) for _ in range(mix["ahead"])]
        self.landed = [None] * mix["ahead"]
        self.kept = [(torch.empty(shape, pin_memory=self.cuda), None)
                     for _ in range(mix["compared_calls"])]
        self.sampler = random.Random(data.sub_seed(self.seed, data.SAMPLE))
        self.calls = 0
        self.window(steps=max(len(self.pool), mix["ahead"] + 1), keep=False)

    def _keep(self, slot: int, which: int) -> None:
        """Reservoir sampling over the window's calls: the call just issued
        (its maps bound for ``self.ring[slot]``, batch ``which``) takes a
        kept place with probability places / calls; its buffer leaves the
        ring, and the place's old buffer takes its turn there (the copies
        all run in one stream, in their order)."""
        k, self.calls = len(self.kept), self.calls + 1
        place = self.calls - 1 if self.calls <= k else self.sampler.randrange(self.calls)
        if place < k:
            old, _ = self.kept[place]
            self.kept[place] = (self.ring[slot], which)
            self.ring[slot] = old

    def _mark(self):
        """A mark of the moment the work issued so far lands: a timed event
        on the card; on the CPU, where a call ends before it returns, the
        host's clock."""
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def window(self, seconds: float | None = None, steps: int | None = None,
               keep: bool = True) -> dict:
        """Calls while ``seconds`` last (or ``steps`` of them), up to
        ``ahead`` in flight; each call's service time (s) in ``latencies``.
        ``keep``: the window's calls enter the check's sample."""
        data.sync(self.device)
        issued, marks = [], []
        t0 = time.perf_counter()
        start = self._mark()
        while (len(issued) < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            n = len(issued)
            which, slot = n % len(self.pool), n % len(self.ring)
            if self.landed[slot] is not None and self.cuda:
                self.landed[slot].synchronize()
            x, oh = self.pool[which]
            issued.append(time.perf_counter())
            with self.spans("call"):
                probs = self.forward(x, oh)
            with self.spans("copy"):
                self.ring[slot].copy_(probs, non_blocking=True)
                del probs
                self.landed[slot] = self._mark()
                marks.append(self.landed[slot])
            if keep:
                self._keep(slot, which)
        with self.spans("sync"):
            data.sync(self.device)
        t1 = time.perf_counter()
        if self.cuda:
            ends = [t0 + start.elapsed_time(m) / 1e3 for m in marks]
        else:
            ends = marks
        latencies = [end - max(issue, before) for issue, end, before
                     in zip(issued, ends, [t0] + ends[:-1])]
        return {"work": len(issued), "images": len(issued) * self.batch,
                "seconds": t1 - t0, "latencies": latencies}

    def flops(self) -> float:
        from portbench.flops import serve_flops
        return serve_flops(self.cfg, self.batch, self.cfg["img_size"])

    def release(self) -> None:
        del self.forward, self.model

    def reference(self, tf32: bool = False) -> list:
        """The reference's maps of every batch of the pool."""
        return reference_maps(self.cfg, self.state, self.pool, tf32)

    def check(self, ref: list | None = None) -> dict:
        """The kept calls' maps against the reference's (of the pool's
        batches: ``ref``, or computed for the kept ones): the largest gap."""
        kept = [(buf, which) for buf, which in self.kept if which is not None]
        if ref is None:
            want = reference_maps(self.cfg, self.state, [self.pool[w] for _, w in kept])
        else:
            want = [ref[w] for _, w in kept]
        return {"prob": max(float((buf - r).abs().max()) for (buf, _), r in zip(kept, want))}

    @staticmethod
    def end_to_end(result: dict) -> dict:
        return {"serve_img_per_s": result["images"] / result["seconds"]}
