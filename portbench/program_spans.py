"""The system's own spans (``mdvit.*``, ``mdvit_tpu_torch/utils/spans.py``)
in the second, host-traced window of a ``trace.TracedWindow``, and what the
per-layer readers take from them.

A device op belongs to a span when the host op that launched it (the
profiler's correlation lists a host op's device ops as its ``kernels``)
started inside one of the span's host intervals, on any thread: PyTorch's
autograd engine issues the CUDA backward from a worker thread of its own,
whose ops are no children of the main thread's span. A device-idle gap
(between two busy intervals of that window) belongs to the innermost
program span open on the host when the gap began. The profiler's per-op
host cost lengthens that window's gaps, so the idle readers give shares of
its idle time, which compare one version of the system with another, not
with the device's untraced pace. Every reader returns None on a window with
no program span, as a system that records none gives, and the device
readers on one with no device op.
"""
from __future__ import annotations

from bisect import bisect_right
from statistics import median

from torch.autograd import DeviceType

from portbench.trace import _union

PREFIX = "mdvit."


def program_spans(w, name: str | None = None) -> list:
    """The host window's program spans (those named ``name``), by start, an
    outer span before the inner ones that start with it."""
    return sorted((e for e in w.events if e.device_type == DeviceType.CPU
                   and e.name.startswith(PREFIX) and name in (None, e.name)),
                  key=lambda e: (e.time_range.start, -e.time_range.end))


def device_ms(w, name: str) -> float | None:
    """Device ms a step or call of the ops launched by host ops that started
    inside a ``name`` span. Spans of one name that overlap (a recompute's
    inside a pull) count as one interval."""
    intervals = _union([(e.time_range.start, e.time_range.end) for e in program_spans(w, name)])
    if not intervals or not w.host_busy:
        return None
    starts = [s for s, _ in intervals]
    total, seen = 0.0, set()
    for e in w.events:  # the profiler gives each device op to the host op that launched it
        if e.device_type != DeviceType.CPU or not e.kernels or e.is_user_annotation \
                or e.id in seen:  # the profiler's own events may share an op's id and kernels
            continue
        seen.add(e.id)
        i = bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= intervals[i][1]:
            total += sum(k.duration for k in e.kernels)
    return total / 1e3 / w.work


def idle_share(w, name: str) -> float | None:
    """% of the host window's device-idle time in gaps that began while
    ``name`` was the innermost open program span."""
    spans = program_spans(w)
    gaps = [(end, start - end) for (_, end), (start, _) in zip(w.host_busy, w.host_busy[1:])]
    total = sum(g for _, g in gaps)
    if not spans or total <= 0:
        return None
    mine, open_, i = 0.0, [], 0
    for t, gap in gaps:  # in time order; a thread's spans nest, so the open ones stack
        while i < len(spans) and spans[i].time_range.start <= t:
            while open_ and open_[-1].time_range.end <= spans[i].time_range.start:
                open_.pop()
            open_.append(spans[i])
            i += 1
        while open_ and open_[-1].time_range.end <= t:
            open_.pop()
        if open_ and open_[-1].name == name:
            mine += gap
    return 100.0 * mine / total


def host_ms(w, name: str) -> float | None:
    """The median host ms of a ``name`` span."""
    spans = program_spans(w, name)
    if not spans:
        return None
    return median(e.time_range.end - e.time_range.start for e in spans) / 1e3
