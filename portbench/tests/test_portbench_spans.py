"""The readers of the system's own spans (``portbench/program_spans.py``) on
synthetic event lists: device time goes to the span its launch fell in, on
any thread; an idle gap goes to the innermost open span; a window without
program spans reads None. Then one tiny traced serving run on the CPU."""
from __future__ import annotations

from itertools import count
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import run, trace
from portbench.tests import tiny

NEW = ("data_device_ms.train", "dropout_device_ms.train", "backward_device_ms.train",
       "forward_idle_share.train", "backward_idle_share.train", "optimizer_idle_share.train",
       "call_host_ms.serve")


IDS = count(1)


def ev(name, start, end, thread=1, kernels=(), annotation=None, id=None):
    """A host op (µs on the trace's clock) and the device ops (name,
    duration µs) the profiler correlated to it; ``annotation`` defaults to
    a program span's being one."""
    return SimpleNamespace(name=name, device_type=DeviceType.CPU, thread=thread,
                           id=next(IDS) if id is None else id,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels],
                           is_user_annotation=name.startswith("mdvit.") if annotation is None
                           else annotation)


def dev(start, end):
    return SimpleNamespace(name="kernel", device_type=DeviceType.CUDA, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end), kernels=[])


def window(events, work=1):
    """What the readers see of a ``trace.TracedWindow``."""
    busy = trace._union([(e.time_range.start, e.time_range.end)
                         for e in trace._device_ops(events)])
    return SimpleNamespace(events=events, work=work, host_busy=busy)


def read(metric, w):
    return run.reader(metric)(w)


def step_events():
    """One step: the main thread's spans and ops, and the autograd engine's
    worker thread issuing the backward's ops inside ``mdvit.backward``."""
    return [
        ev("portbench.step", 0, 200, annotation=True),
        ev("mdvit.train_step", 1, 199),
        ev("mdvit.data", 2, 20), ev("aten::index_select", 3, 5, kernels=[("gather", 4.0)]),
        ev("aten::bitwise_xor", 6, 8, kernels=[("xor", 6.0)]),
        ev("mdvit.forward", 21, 80), ev("aten::mm", 22, 25, kernels=[("gemm", 10.0)]),
        ev("mdvit.dropout", 30, 40), ev("aten::rshift", 31, 33, kernels=[("rshift", 5.0)]),
        ev("aten::where", 34, 36, kernels=[("where", 2.0)]),
        ev("mdvit.backward", 90, 150, kernels=[("mdvit.backward", 55.0)]),
        ev("autograd::engine::evaluate_function: MmBackward0", 92, 120, thread=2),
        ev("aten::mm", 93, 96, thread=2, kernels=[("gemm", 20.0), ("gemm", 12.0)], id=900),
        # the profiler's own event, sharing the op's id and so its kernels
        ev("Activity Buffer Request", 94, 94, thread=2, kernels=[("gemm", 20.0), ("gemm", 12.0)],
           annotation=False, id=900),
        ev("aten::mul", 140, 141, thread=2, kernels=[("mul", 3.0)]),
        ev("aten::add", 160, 161, thread=2, kernels=[("add", 100.0)]),  # after the pull
        ev("mdvit.optimizer", 170, 195), ev("aten::_foreach_add", 171, 173,
                                            kernels=[("adam", 8.0)]),
    ]


@pytest.mark.parametrize("metric,ms", [("data_device_ms.train", 10e-3),
                                       ("dropout_device_ms.train", 7e-3),
                                       ("backward_device_ms.train", 35e-3)])
def test_device_time_goes_to_the_span_its_launch_fell_in(metric, ms):
    """Backward: two ops the worker thread launched inside the pull (32 +
    3 µs), once each, not the one launched after it, nor the span's own
    device-timeline annotation; each a step over the window's two steps."""
    w = window(step_events() + [dev(0, 1)])
    assert read(metric, w) == pytest.approx(ms)
    w.work = 2
    assert read(metric, w) == pytest.approx(ms / 2)


def test_a_gap_goes_to_the_innermost_open_program_span():
    """Busy 5–10, 24–28, 35–38, 100–130, 172–180 µs: the gaps begin at 10
    (data, 14 µs), 28 (forward, 7), 38 (dropout inside forward, 62), 130
    (backward, 42); 125 µs of idle in all."""
    events = step_events() + [dev(5, 10), dev(24, 28), dev(35, 38), dev(100, 130),
                              dev(172, 180)]
    w = window(events)
    shares = {m: read(m, w) for m in NEW[3:6]}
    assert shares == pytest.approx({"forward_idle_share.train": 100 * 7 / 125,
                                    "backward_idle_share.train": 100 * 42 / 125,
                                    "optimizer_idle_share.train": 0.0})


def test_the_gap_at_a_span_boundary_and_outside_every_span():
    """A gap beginning as the forward closes belongs to the step around it;
    one beginning outside every program span to none of them."""
    events = [ev("mdvit.train_step", 0, 100), ev("mdvit.forward", 0, 50),
              dev(10, 50), dev(60, 70), dev(200, 210)]
    w = window(events)
    assert read("forward_idle_share.train", w) == 0.0
    events[1].time_range.end = 51
    assert read("forward_idle_share.train", w) == pytest.approx(100 * 10 / 140)


def test_call_host_ms_is_the_median_serving_span():
    w = window([ev("mdvit.serve", 0, 100), ev("mdvit.serve", 200, 500),
                ev("mdvit.serve", 600, 800), dev(1, 90)])
    assert read("call_host_ms.serve", w) == pytest.approx(0.2)


@pytest.mark.parametrize("metric", NEW)
def test_a_window_without_program_spans_reads_none(metric):
    """The system before it had spans: the harness's own spans, device ops
    and their host ops, no ``mdvit.*`` span."""
    events = [ev("portbench.step", 0, 100, annotation=True),
              ev("aten::mm", 5, 9, kernels=[("gemm", 4.0)]), dev(6, 10), dev(20, 30)]
    assert read(metric, window(events)) is None


@pytest.mark.parametrize("metric", NEW[:6])
def test_no_device_op_no_device_reading(metric):
    """A window with spans and no device op (a CPU run) reads None."""
    assert read(metric, window(step_events())) is None


def test_a_tiny_traced_serving_run_reads_the_call_span():
    """The CPU's traced window holds the system's spans: the call's host ms
    is read, the device readers read nothing."""
    bench, cfg, mix = tiny.cell("mdvit.serve.b256")
    line = run.run_cell(bench, "mdvit.serve.b256", cfg, mix, 2**33 + 5, 0.2, True, "cpu")
    assert line["metrics"]["call_host_ms.serve"]["value"] > 0
    assert "device_idle_share.serve" not in line["metrics"]
