"""The port's profiler spans (``mdvit_tpu_torch/utils/spans.py``) on the CPU:
each span of the train step, the dropouts and the serving call appears, as
often as the work it covers runs, nested as the module's list says; with no
profiler recording a span never enters ``record_function``; and the spans
change no number, generator state or kernel call of a step."""
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.ops import dwconv
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.predict import make_forward
from mdvit_tpu_torch.train.optim import build_optimizer
from mdvit_tpu_torch.train.steps import make_train_step
from mdvit_tpu_torch.utils import spans

torch.set_num_threads(2)

IMG, D = 32, 4
TINY = dict(embed_dims=(16, 32, 40, 64), num_layers=(1, 1, 1, 1))
PHASES = ("mdvit.data", "mdvit.forward", "mdvit.backward", "mdvit.optimizer")
# model, its step's objective, backward pulls a step (MDViT's second pull
# takes the domain-gate gradients of the unified loss alone)
KINDS = {"MDViT": (True, 2), "BASE": (False, 1)}
OPS = {"factorized_attention": fa._attention_op, "factorized_attention_bwd": fa._attention_bwd_op,
       "cpe_conv": dwconv._cpe_op, "cpe_conv_bwd": dwconv._cpe_bwd_op,
       "crpe_conv": dwconv._crpe_op, "crpe_conv_bwd": dwconv._crpe_bwd_op}


def _batch():
    g = torch.Generator().manual_seed(3)
    images = [torch.randint(0, 256, (3, IMG, IMG, 3), dtype=torch.uint8, generator=g)
              for _ in range(D)]
    masks = [torch.randint(0, 2, (3, IMG, IMG), dtype=torch.uint8, generator=g)
             for _ in range(D)]
    return images, masks, torch.tensor([[0, 1]] * D)


def _step(name):
    """A tiny ``name`` and its train step (dropout and drop path 0.1), from
    one seed."""
    model = build_model(name, img_size=IMG, device="cpu", seed=5, **TINY)
    optimizer, scheduler = build_optimizer(model, steps_per_epoch=10)
    return model, make_train_step(model, optimizer, scheduler, D, mkd=KINDS[name][0], seed=9)


def _program_spans(prof):
    """The profile's program spans (name, start, end, thread), each with
    ``parent``, the nearest program span on its thread that holds it. Read
    from the profiler's raw events: building its ``FunctionEvent`` tree
    takes seconds a step here."""
    out = [SimpleNamespace(name=e.name(), start=e.start_ns(), end=e.end_ns(),
                           thread=e.start_thread_id(), parent=None)
           for e in prof.profiler.kineto_results.events() if e.name().startswith("mdvit.")]
    for e in out:
        holders = [p for p in out if p is not e and p.thread == e.thread
                   and p.start <= e.start and e.end <= p.end]
        e.parent = max(holders, key=lambda p: p.start, default=None)
    return sorted(out, key=lambda e: e.start)


def _run(name, monkeypatch, profiled):
    """One step: its metrics, gradients, parameters, generator states and
    the custom ops' CPU kernel calls (what a card launches), and the
    profile's program spans when ``profiled``."""
    calls = dict.fromkeys(OPS, 0)
    for op_name, op in OPS.items():
        def counted(*a, _fn=op._backend_fns["cpu"], _name=op_name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setitem(op._backend_fns, "cpu", counted)
    model, step = _step(name)
    events = []
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            metrics = step(*_batch())
        events = _program_spans(prof)
    else:
        metrics = step(*_batch())
    monkeypatch.undo()
    return {"metrics": metrics, "calls": calls,
            "grads": [p.grad.clone() for p in model.parameters()],
            "params": [p.detach().clone() for p in model.parameters()],
            "gens": [step.generator.get_state(), step.aug_generator.get_state()],
            "spans": events}


@pytest.fixture(scope="module")
def steps():
    """Each kind's step, unprofiled and profiled, from one seed."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in KINDS:
            out[name] = {on: _run(name, mp, on) for on in (False, True)}
    return out


@pytest.mark.parametrize("name", list(KINDS))
def test_each_train_span_appears_as_often_as_its_work(steps, name):
    names = [e.name for e in steps[name][True]["spans"]]
    want = {"mdvit.train_step": 1, "mdvit.data": 1, "mdvit.forward": 1,
            "mdvit.backward": KINDS[name][1], "mdvit.optimizer": 1}
    assert {k: names.count(k) for k in want} == want
    assert names.count("mdvit.dropout") > 0
    assert set(names) == {*want, "mdvit.dropout"}


@pytest.mark.parametrize("name", list(KINDS))
def test_train_spans_nest_as_the_module_says(steps, name):
    for e in steps[name][True]["spans"]:
        if e.name == "mdvit.train_step":
            assert e.parent is None
        elif e.name == "mdvit.dropout":
            assert e.parent.name == "mdvit.forward"
        else:
            assert e.name in PHASES and e.parent.name == "mdvit.train_step"


@pytest.mark.parametrize("name", list(KINDS))
def test_spans_change_no_number_of_the_step(steps, name):
    """Losses, gradients, parameters, generator states and the custom ops'
    calls are bit-equal with and without a profiler recording the spans."""
    off, on = steps[name][False], steps[name][True]
    assert off["metrics"].keys() == on["metrics"].keys()
    assert all(torch.equal(off["metrics"][k], on["metrics"][k]) for k in off["metrics"])
    for key in ("grads", "params", "gens"):
        assert all(torch.equal(a, b) for a, b in zip(off[key], on[key], strict=True)), key
    assert off["calls"] == on["calls"] and off["calls"]["factorized_attention_bwd"] > 0


def test_a_serving_call_is_one_serve_span():
    model = build_model("MDViT", img_size=IMG, device="cpu", seed=5, **TINY)
    forward = make_forward(model)
    x = torch.rand(2, IMG, IMG, 3) * 255
    onehot = torch.eye(D)[:2]
    want = forward(x, onehot)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [forward(x, onehot) for _ in range(2)]
    assert [e.name for e in _program_spans(prof)] == ["mdvit.serve", "mdvit.serve"]
    assert all(torch.equal(g, want) for g in got)


def test_without_a_profiler_a_span_never_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert spans.span("mdvit.data") is spans.span("mdvit.forward")
    _, step = _step("MDViT")
    step(*_batch())
    make_forward(build_model("BASE", img_size=IMG, device="cpu", **TINY))(
        torch.rand(2, IMG, IMG, 3), torch.eye(D)[:2])
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError):
        spans.span("mdvit.data")
