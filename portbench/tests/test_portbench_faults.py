"""A run with the timed path broken underneath (the harness's look for a
chip skipped, the rest of a run driven on the CPU at tiny widths) comes
out not correct, once for each fault the cell can have: a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest; an answer altered where it is produced. (One chip: no
exchange between chips to leave out.)"""
from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests import tiny

TRAIN = ("mdvit.train.d4b16", "base.train.d4b16")


def _run(cell: str) -> dict:
    bench, cfg, mix = tiny.cell(cell)
    return run.run_cell(bench, cell, cfg, mix, 2**32 + 21, 0.3, False, "cpu")


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    line = _run(cell)
    assert not line["correct"] and line["compared"]["update"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from mdvit_tpu_torch.train import steps

    gather = steps.gather_batch

    def half(images, masks, indices, rows=None):
        return gather(images, masks, indices[:, :indices.shape[1] // 2])

    monkeypatch.setattr(steps, "gather_batch", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_loss_altered_where_it_is_produced(cell, monkeypatch):
    from mdvit_tpu_torch.train import steps

    losses = steps.per_domain_losses

    def altered(*a):
        seg, *rest = losses(*a)
        return (seg * 1.01, *rest)

    monkeypatch.setattr(steps, "per_domain_losses", altered)
    assert not _run(cell)["correct"]


def test_serving_answer_altered(monkeypatch):
    from mdvit_tpu_torch import predict

    forward = predict.Serving.forward

    def altered(self, x, onehot):
        out = forward(self, x, onehot)
        return torch.cat([1.0 - out[:1], out[1:]])

    monkeypatch.setattr(predict.Serving, "forward", altered)
    assert not _run("mdvit.serve.b256")["correct"]


def test_serving_half_of_the_batch_left_out(monkeypatch):
    from mdvit_tpu_torch import predict

    forward = predict.Serving.forward

    def half(self, x, onehot):
        b = x.shape[0] // 2
        out = forward(self, x[:b], onehot[:b])
        return torch.cat([out, torch.zeros_like(out)])

    monkeypatch.setattr(predict.Serving, "forward", half)
    assert not _run("mdvit.serve.b256")["correct"]
