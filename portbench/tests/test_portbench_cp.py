"""The ``cp_train`` kind at tiny widths on the CPU over 2 gloo ranks (the
harness's process rank 0, one spawned): set-up, a window of 2 steps, the
check against the cell's limits; both planted faults read above them. Then
the context-parallel readers on synthetic events, and the split attention
ops' counts at a hand-worked shape (their workspace in the count's own
layout)."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import run, trace
from portbench.calibrate_cp import FAULTS, plan
from portbench.counts import counter
from portbench.tests import tiny
from portbench.tests.test_portbench_spans import dev, ev, window
from portbench.traffic import cp_train
from portbench.traffic.train import compare

CELL = "base.train.cp4.r1024"
LIMITS = json.loads((run.HERE / "limits" / f"{CELL}.json").read_text())["limits"]


@pytest.fixture(scope="module")
def traffic():
    _, _, cfg, mix = run.cell_spec(CELL)
    cfg = {**cfg, **tiny.WIDTHS}
    mix = {**mix, "ranks": 2, "per_domain_batch": 2, "per_domain_store": 4,
           "compared_steps": 2, "trace_work": 2}
    t = cp_train.Traffic(cfg, mix, 2**32 + 21, "cpu", trace.Spans(False))
    t.setup()
    result = t.window(steps=2)
    t.release()
    return t, result


def test_sound_run_is_correct(traffic):
    t, result = traffic
    assert result["work"] == 2 and result["images"] == 2 * 4 * 2 and result["seconds"] > 0
    assert all(p.exitcode == 0 for p in t.procs)
    ok, compared = run.judged(t.check(), LIMITS)
    assert ok, compared
    assert compared["ranks_apart"]["value"] == 0.0


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_reads_above_the_limits(traffic, fault):
    t, _ = traffic
    numbers = compare(t.reference(fault=fault), t.reference(), t.mix["excluded_below"])
    assert not run.judged(numbers, LIMITS)[0], numbers


def test_calibration_plan_spreads_the_references():
    share = plan(list(range(100, 112)), 3, 4)
    assert sorted(i for s in share for i, _ in s) == list(range(12))
    assert [s[0][0] for s in share[:3]] == [0, 1, 2]   # a faulted seed a card
    loads = [sum(1 + 3 * (i < 3) for i, _ in s) for s in share]
    assert max(loads) - min(loads) <= 1


def op(name, start, end):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end), kernels=[])


@pytest.mark.parametrize("ops,share", [
    # an NCCL kernel 0–100 µs under compute 50–150: 50 µs exposed of 1 ms
    ([("ncclDevKernel_AllGather_RING_LL", 0, 100), ("gemm", 50, 150)], 5.0),
    # wholly under compute: nothing exposed
    ([("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 20, 80), ("gemm", 0, 100)], 0.0),
    # two NCCL kernels overlapping each other, compute in the middle: 0–40 and 60–90
    ([("ncclDevKernel_AllGather_RING_LL", 0, 70), ("ncclKernel_AllReduce", 50, 90),
      ("gemm", 40, 60)], 7.0),
])
def test_exposed_comm_share(ops, share):
    w = SimpleNamespace(device_ops=[op(*o) for o in ops], window_s=1e-3)
    assert run.reader("cp_exposed_comm_share.train")(w) == pytest.approx(share)


def test_exposed_comm_share_without_nccl_reads_nothing():
    w = SimpleNamespace(device_ops=[op("gemm", 0, 10)], window_s=1e-3)
    assert run.reader("cp_exposed_comm_share.train")(w) is None


def test_collective_spans_per_step_and_their_device_time():
    events = [ev("mdvit.train_step", 0, 100),
              ev("mdvit.cp.halo", 1, 5), ev("c10d::allgather_", 2, 4, kernels=[("nccl", 6.0)]),
              ev("mdvit.cp.reduce", 10, 14), ev("aten::cat", 11, 12, kernels=[("cat", 1.0)]),
              ev("c10d::allreduce_", 12, 13, kernels=[("nccl", 3.0)]),
              ev("mdvit.cp.gather", 30, 35, thread=2),
              ev("c10d::allgather_", 31, 34, thread=2, kernels=[("nccl", 8.0)]),
              ev("aten::mm", 40, 45, kernels=[("gemm", 50.0)]), dev(2, 60)]
    w = window(events, work=2)
    assert run.reader("cp_collectives_per_step.train")(w) == 1.5
    assert run.reader("cp_halo_device_ms.train")(w) == pytest.approx(3e-3)
    assert run.reader("cp_reduce_device_ms.train")(w) == pytest.approx(2e-3)
    assert run.reader("cp_gather_device_ms.train")(w) == pytest.approx(4e-3)
    assert run.reader("cp_collectives_per_step.train")(window(events[-1:])) is None


def test_data_device_ms_reads_the_benchmark_data_span():
    """The gather and augmentation of the global batch, in the harness's
    ``portbench.data`` span, a step; the step's ops outside it are not
    counted, nor a span of the system's."""
    events = [ev("portbench.data", 0, 10, annotation=True),
              ev("aten::index", 1, 3, kernels=[("index", 4.0)]),
              ev("mdvit::augment", 4, 9, kernels=[("hash", 6.0), ("warp", 2.0)]),
              ev("portbench.step", 11, 100, annotation=True),
              ev("mdvit.train_step", 12, 99),
              ev("aten::mm", 20, 30, kernels=[("gemm", 50.0)]), dev(2, 60)]
    assert run.reader("cp_data_device_ms.train")(window(events, work=2)) == pytest.approx(6e-3)
    assert run.reader("cp_data_device_ms.train")(window(events[3:])) is None


def test_split_attention_counts():
    # B=2, N=300, C=16 (2 heads of ch 8, bucket 8: 80 floats a forward
    # partial, 144 a backward one; 256 forward rows a chunk, 256 backward:
    # 2 chunks of 300), fp32
    b, n, c, ch = 2, 300, 16, 8
    vals = b * n * c
    ws_fwd, ws_bwd = 4 * 2 * 80, 4 * 2 * 144           # (b·heads) · chunks · floats
    assert counter("mdvit::factorized_attention_partials")([[b, n, c]] * 2 + [[]],
                                                           [None, None, ch], 4) == (
        vals * 20.0, 2 * vals * 4.0 + 4 * ws_fwd)
    assert counter("mdvit::factorized_attention_bwd_partials")([[b, n, c]] * 4 + [[]],
                                                               [None] * 4 + [ch], 4) == (
        vals * 36.0, 4 * vals * 4.0 + 4 * ws_bwd)
    # the apply ops read the workspace gathered from 2 ranks: 4 partials a (b, h)
    gathered_fwd, gathered_bwd = [4, 4 * 80], [4, 4 * 144]
    assert counter("mdvit::factorized_attention_apply")([[b, n, c], gathered_fwd, [], []],
                                                        [None, None, ch, 0.35], 4) == (
        vals * 17.0 + 2 * 4 * 320, 2 * vals * 4.0 + 4 * 4 * 320)
    assert counter("mdvit::factorized_attention_bwd_apply")(
        [[b, n, c]] * 3 + [gathered_bwd, [], []], [None] * 4 + [ch, 0.35], 4) == (
        vals * 54.0 + 2 * 4 * 576, 6 * vals * 4.0 + 4 * 4 * 576)
