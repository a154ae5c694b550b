"""The end-to-end arithmetic: a stall planted in a window lowers
``train_img_per_s`` and ``serve_img_per_s``, and raises the serving
window's call tail (``call_p95_ms.serve``)."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from portbench import run, trace
from portbench.tests import tiny
from portbench.traffic import serve, train


def test_rates_and_tail_on_synthetic_records():
    steady = {"work": 10, "images": 640, "seconds": 6.0}
    stalled = {**steady, "seconds": 6.5}
    assert train.Traffic.end_to_end(stalled)["train_img_per_s"] < \
        train.Traffic.end_to_end(steady)["train_img_per_s"] == pytest.approx(640 / 6.0)
    lat = [0.08] * 100
    calls = {"work": 100, "images": 12800, "seconds": 8.0, "latencies": lat}
    late = {**calls, "seconds": 8.5, "latencies": lat[:94] + [0.5] * 6}
    tail = run.reader("call_p95_ms.serve")
    assert tail(SimpleNamespace(latencies=calls["latencies"])) == pytest.approx(80.0)
    assert tail(SimpleNamespace(latencies=late["latencies"])) == pytest.approx(500.0)
    assert serve.Traffic.end_to_end(late)["serve_img_per_s"] < \
        serve.Traffic.end_to_end(calls)["serve_img_per_s"]


def test_nearest_rank_p95():
    assert serve.p95([float(i) for i in range(1, 101)]) == 95.0
    assert serve.p95([float(i) for i in range(1, 21)]) == 19.0
    assert serve.p95([3.0]) == 3.0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_stall_in_a_window_shows(cell, monkeypatch):
    """A real tiny window with one 1 s stall planted in the system's
    entry: the rate falls, and a call's latency counts the stall."""
    import importlib

    _, cfg, mix = tiny.cell(cell)
    module = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    t = module.Traffic(cfg, mix, 12, "cpu", trace.Spans(False))
    t.setup()
    plain = module.Traffic.end_to_end(t.window(steps=3))
    attr = "step" if mix["kind"] == "train" else "forward"
    inner, calls = getattr(t, attr), []

    def stalled(*a):
        calls.append(1)
        if len(calls) == 2:
            time.sleep(1.0)
        return inner(*a)

    monkeypatch.setattr(t, attr, stalled)
    window = t.window(steps=3)
    late = module.Traffic.end_to_end(window)
    rate, = late
    assert late[rate] < plain[rate]
    if "latencies" in window:
        assert serve.p95(window["latencies"]) >= 1.0
