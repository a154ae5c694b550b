"""The traced window: a ``torch.profiler`` record of the window's device
ops (kernels, copies, memsets) and host ops, and what the per-layer
readers take from it.

Busy time is the union of the device ops' intervals; a device op is
attributed to the host op that launched it (the profiler's correlation),
and a host op's device time counts the ops launched under it and under its
children. The benchmark's own host spans (``portbench.step``,
``portbench.sync``, ...) say what the host was doing during each idle gap
of the device.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Iterator

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "portbench."


class Spans:
    """The benchmark's host spans: profiler ranges when tracing, nothing
    otherwise (so an untraced window pays no more than a function call)."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        return record_function(SPAN_PREFIX + name) if self.on else contextlib.nullcontext()


@contextlib.contextmanager
def recording(host: bool) -> Iterator[list]:
    """Profile the block: the device's ops alone, or (``host``) the host's
    ops too, with their argument shapes; the list it yields holds the
    profile once the block has ended."""
    out: list = []
    device = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    acts = [ProfilerActivity.CPU] + device if host or not device else device
    with profile(activities=acts, record_shapes=host) as prof:
        yield out
    out.append(prof)


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _device_ops(events) -> list:
    # record_function ranges also appear on the device's timeline, as
    # annotations spanning the ops launched inside them: not ops
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


class TracedWindow:
    """What the readers see, from two traced windows of the same work one
    after the other. The first traces the device alone, which costs the
    host little, so the host paces the device as in an untraced window:
    its host-clock seconds, busy time, idle share and device ops. The
    second traces the host too: which host op launched which device op,
    and what the host was doing in each idle gap; the profiler slows the
    host there, so its gaps are longer than the first window's.

    ``window`` is the first window's record (its seconds, its ``work``:
    the steps or calls of each window, and a serving window's per-call
    ``latencies``); ``flops`` the model FLOPs of one step or call (the plain
    reference's, counted at set-up); ``peaks`` the card's published peaks;
    ``elem_bytes`` the bytes of an activation value."""

    def __init__(self, device_prof, host_prof, window: dict, flops: float | None,
                 peaks: dict | None, elem_bytes: int):
        self.window_s, self.work = window["seconds"], window["work"]
        self.latencies = window.get("latencies")
        self.flops, self.peaks, self.elem_bytes = flops, peaks, elem_bytes
        self.device_ops = _device_ops(device_prof.events())
        self.busy = _union([(e.time_range.start, e.time_range.end) for e in self.device_ops])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        self.events = list(host_prof.events())
        self.host_busy = _union([(e.time_range.start, e.time_range.end)
                                 for e in _device_ops(self.events)])

    def outermost(self, names) -> list:
        """The host ops named in ``names`` that have no ancestor named in it
        (a custom op's dispatch repeats its name one level down)."""
        names = set(names)
        out = []
        for e in self.events:
            if e.device_type != DeviceType.CPU or e.name not in names:
                continue
            parent = e.cpu_parent
            while parent is not None and parent.name not in names:
                parent = parent.cpu_parent
            if parent is None:
                out.append(e)
        return out

    def device_s(self, events) -> float:
        """Device seconds of the ops launched under ``events``."""
        return sum(e.device_time_total for e in events) / 1e6

    def top_device_ops(self, n: int = 10) -> list:
        by_name: dict = defaultdict(float)
        for e in self.device_ops:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Seconds of device idle between busy intervals of the second
        window, summed by the benchmark's host span open when each gap
        began (``none``: none)."""
        spans = sorted((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):])
                       for e in self.events if e.device_type == DeviceType.CPU
                       and e.name.startswith(SPAN_PREFIX))
        by_span: dict = defaultdict(float)
        for (_, end), (start, _) in zip(self.host_busy, self.host_busy[1:]):
            open_ = [name for s, e, name in spans if s <= end < e]
            by_span[open_[-1] if open_ else "none"] += (start - end) / 1e6
        return [[k, v] for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_device_ops(), "idle_gaps": self.idle_gaps()}


def idle_pct(w: TracedWindow) -> float | None:
    """The share of the window in which no device op ran, %."""
    return 100.0 * (1.0 - w.busy_s / w.window_s) if w.device_ops else None


def ops_per_work(w: TracedWindow) -> float | None:
    """Device ops (kernels, copies, memsets) a step or call."""
    return len(w.device_ops) / w.work if w.device_ops else None


def mfu_pct(w: TracedWindow) -> float | None:
    """Model FLOPs of the window's work over its seconds, as a share of the
    card's peak at the configuration's precision, %."""
    if w.flops is None or not w.peaks:
        return None
    return 100.0 * w.flops * w.work / w.window_s / w.peaks["flop_per_s"]


def roofline_pct(w: TracedWindow, ops) -> float | None:
    """Σ over the window's calls of ``ops`` of the least time the card
    could take (the larger of FLOPs over the peak and bytes over the
    bandwidth), over the device time of the ops those calls launched, %."""
    from portbench.counts import counter

    calls = w.outermost(ops)
    device_s = w.device_s(calls)
    if not calls or not w.peaks or device_s <= 0:
        return None
    bound = 0.0
    for e in calls:
        flops, nbytes = counter(e.name)(e.input_shapes, e.concrete_inputs, w.elem_bytes)
        bound += max(flops / w.peaks["flop_per_s"], nbytes / w.peaks["bytes_per_s"])
    return 100.0 * bound / device_s
