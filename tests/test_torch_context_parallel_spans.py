"""The context-parallel train step's spans and collective counts, and its
agreement with the benchmark's plain reference (``portbench/reference/cp.py``),
on the CPU: BASE at the benchmark's tiny widths (``portbench/tests/tiny.py``)
at 64², a batch of 4 domains × 2 images gathered and augmented from uint8
stores as the benchmark's ranks do, over 2 gloo ranks (one spawn,
``torch_cp.spans_worker``): each rank's step once with no profiler and once
under ``torch.profiler``, from the same state."""
import math

import pytest
import torch

import torch_cp
import torch_dp
from portbench import data, run, weights
from portbench.reference import cp as ref_cp
from portbench.reference import train as ref_train
from portbench.tests import tiny
from portbench.traffic.train import compare, leaf_norms

torch.set_num_threads(2)

CELL = "base.train.cp4.r1024"
SEED = 2**32 + 3
STEP_SPANS = ("mdvit.train_step", "mdvit.forward", "mdvit.backward", "mdvit.optimizer")
# the reference against the ranks, fp32: the same sums in other orders (the
# ranks' blocks, the loss from per-rank sums, the per-rank gradients
# all-reduced) move the loss by ~1e-7 of itself and a gradient leaf by ~1e-6
# of its largest value at these sizes; 10x and more room
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the cell's numbers: the update is a difference of two fp32 parameters (a
# step of ~1e-4 on values up to ~0.3 carries their rounding, ~1e-4 of it)
CELL_TOL = {"loss": LOSS_RTOL, "grad": GRAD_RTOL, "update": 1e-3}


def _setup():
    _, _, cfg, _ = run.cell_spec(CELL)
    cfg = {**cfg, **tiny.WIDTHS}
    stores = data.stores(SEED, cfg["num_domains"], 2, cfg["img_size"], "cpu")
    indices = data.Epochs(SEED, cfg["num_domains"], 2, 2, "cpu").next()
    return cfg, weights.from_seed(cfg, SEED, "cpu"), stores, indices


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    cfg, state, stores, indices = _setup()
    spec = tmp / "spec.pt"
    torch.save({"cfg": cfg, "seed": SEED, "state": state, "stores": stores,
                "indices": indices}, spec)
    return torch_dp.spawn(torch_cp.spans_worker, 2, tmp, str(spec), str(tmp / "out"))


def _reference(blocked: bool = True) -> dict:
    """One step of the plain reference from the ranks' state: its loss, its
    gradients, the parameters after it."""
    cfg, state, stores, indices = _setup()
    model = ref_train.build(cfg)
    model.load_state_dict(state)
    step = ref_cp.Step(model, cfg, 1, SEED, ranks=2, blocked=blocked, samples=3)
    loss, grads = step(*stores, indices)
    return {"loss": loss, "grads": dict(zip((n for n, _ in step.named), grads)),
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def test_profiler_records_the_step_spans_and_a_span_around_each_collective(ranks):
    for r in ranks:
        events = r["profiled"]["events"]
        names = [n for n, *_ in events]
        assert all(names.count(s) == 1 for s in STEP_SPANS)
        spans = [e for e in events if e[0].startswith("mdvit.cp.")]
        calls = [e for e in events if e[0].startswith("c10d::")]
        assert spans and len(spans) == len(calls)

        def inside(call, span):
            return call[1] == span[1] and span[2] <= call[2] and call[3] <= span[3]

        # every collective in exactly one span, every span around exactly one
        assert all(sum(inside(c, s) for s in spans) == 1 for c in calls)
        assert all(sum(inside(c, s) for c in calls) == 1 for s in spans)


def test_no_span_entered_without_a_profiler(ranks):
    for r in ranks:
        assert r["plain"]["entered"] == []


def test_profiler_leaves_the_numbers_bit_equal(ranks):
    for r in ranks:
        plain, profiled = r["plain"], r["profiled"]
        assert torch.equal(plain["loss"], profiled["loss"])
        for n, p in plain["params"].items():
            assert torch.equal(p, profiled["params"][n]), n


def test_collectives_counted_by_kind(ranks):
    """BASE at these widths has 8 attention blocks (one a stage: 4 encoder
    stages, 4 decoder stages) and 12 BatchNorms (2 stem convs, 4 patch
    embeds, 2 bridge convs, 4 decoder merges), on 2 ranks:

    - gather 16: A's workspace in each block's forward and A′'s in its
      backward;
    - reduce 28: each BatchNorm's moments forward and their gradient
      backward (24), the loss's sums forward and backward (2), stage 4's
      spatial mean (``feat``, forward only: the loss does not read it) and
      the flat gradient (2);
    - halo 63: 32 forward, every conv and resize that reads rows of its
      neighbours (8 CPE and 8 CRPE, 4 CRPE of them from the whole grid
      where a rank holds fewer rows than its halo of 3; 2 stem convs, 4
      patch embeds, 2 bridge convs, 4 decoder merges; 3 decoder upsamples
      and the head's), and each one's backward but the first stem conv's,
      whose input needs no gradient (31).

    Bytes: each call's payload on this rank, every call counted once."""
    for r in ranks:
        for mode in ("plain", "profiled"):
            got = r[mode]["collectives"]
            assert {k: v["calls"] for k, v in got.items()} == {
                "halo": 63, "gather": 16, "reduce": 28}
            assert all(v["bytes"] > 0 for v in got.values())
        events = [n for n, *_ in r["profiled"]["events"]]
        assert {k: events.count(f"mdvit.cp.{k}") for k in ("halo", "gather", "reduce")} == {
            "halo": 63, "gather": 16, "reduce": 28}


def test_step_agrees_with_the_plain_reference(ranks):
    """Loss, gradients and the update of one step against
    ``portbench/reference/cp.py`` (the whole batch on one process, BN
    moments per domain, one loss of the whole batch, AdamW), from the same
    weights, stores and seeds: the loss within ``LOSS_RTOL``, each gradient
    leaf within ``GRAD_RTOL`` of its largest value or of the median leaf's,
    whichever is larger (a leaf whose true gradient is 0, a conv bias before
    a BatchNorm, holds rounding alone), and the cell's own numbers
    (``traffic.train.compare``) within ``CELL_TOL``."""
    ref = _reference()
    _, state, _, _ = _setup()

    def record(r):
        return {"losses": [{"loss": float(r["loss"])}], "grad": leaf_norms(r["grads"]),
                "update": leaf_norms({n: p - state[n] for n, p in r["params"].items()})}

    tops = {n: float(g.abs().max()) for n, g in ref["grads"].items()}
    floor = sorted(tops.values())[len(tops) // 2]
    for r in ranks:
        got = r["plain"]
        assert math.isclose(float(got["loss"]), ref["loss"], rel_tol=LOSS_RTOL)
        for n, g in ref["grads"].items():
            err = float((got["grads"][n] - g).abs().max())
            assert err <= GRAD_RTOL * max(tops[n], floor), n
        numbers = compare(record(got), record(ref), 1e-3)
        assert all(numbers[k] <= CELL_TOL[k] for k in CELL_TOL), numbers


def test_blocked_reference_is_bit_equal_to_the_unblocked():
    """Checkpointed pieces, dropout's masks hashed 3 samples at a time (of
    8: a short last slice), against the whole batch at once."""
    blocked, whole = _reference(True), _reference(False)
    assert blocked["loss"] == whole["loss"]
    for n, g in whole["grads"].items():
        assert torch.equal(blocked["grads"][n], g), n
        assert torch.equal(blocked["params"][n], whole["params"][n]), n
