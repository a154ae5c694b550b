"""Activation recomputation (``tpu.remat``) in the port's train step, on the
CPU: ``make_train_step(remat=True)`` runs the model call under a
non-reentrant ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint`` around the
whole forward, ``mdvit_tpu/train/steps.py:160-161``).

* From one state, one remat step and one plain step give the same losses,
  bit-equal BN running stats and dropout-generator state, and the same
  parameter updates, with dropout and stochastic depth on: each recompute
  replays the forward's seeds and writes no running stats. The model's
  forward runs once more a backward pull: 3 times for MKD with the Sup gate
  (two pulls), 2 times for a one-pull model (BASE_DSN, the DSN norms).
* The remat step against JAX's ``make_train_step(remat=True)`` on MDViT_DSN
  (MKD, Sup gate, DSN norms), dropout 0, with the tolerances of
  tests/test_torch_train_step.py (tests/torch_family.py).
* ``tpu.remat`` in a config reaches the trainer's step.
"""
import copy
import functools
import json
import os
from unittest import mock

import pytest
import torch

import mdvit_tpu_torch.train.steps as steps
from mdvit_tpu_torch import cli
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.train.optim import build_optimizer
from torch_family import check_batch_stats, check_gradients, check_metrics, train_case

torch.set_num_threads(2)

# tests/test_torch_train_step.py's narrow model: img 64, D = 4, B = 2
IMG, D, B = 64, 4, 2
NARROW = dict(num_layers=(1, 1, 1, 1), embed_dims=(16, 32, 40, 64))
DROP = 0.1
# relative L2 of the parameter updates, remat against plain: the recomputed
# activations are the forward's bits on the CPU, so the updates are too
UPDATE_REL_TOL = 1e-6
# model → forward runs a remat step makes: 1 + one recompute a backward pull
ROWS = {"MDViT": 3, "BASE_DSN": 2}


def _batch(seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    images = [torch.randint(0, 256, (3, IMG, IMG, 3), generator=gen, dtype=torch.uint8)
              for _ in range(D)]
    masks = [(torch.rand(3, IMG, IMG, generator=gen) > 0.5).to(torch.uint8)
             for _ in range(D)]
    return images, masks, torch.tensor([[0, 2], [1, 0], [2, 2], [1, 1]])


def _run(model, remat: bool, steps_to_run: int = 2):
    """``steps_to_run`` steps; per step the metrics, the parameter update,
    the buffers, the generator state and the model's forward runs."""
    calls = [0]
    hook = model.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    opt, sched = build_optimizer(model, steps_per_epoch=10)
    step = steps.make_train_step(model, opt, sched, D, mkd=model.config["name"].startswith("MDViT"),
                                 device_augment=False, remat=remat, seed=3)
    out = []
    for _ in range(steps_to_run):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        calls[0] = 0
        metrics = step(*_batch())
        out.append({"metrics": metrics, "calls": calls[0],
                    "update": {n: p.detach() - before[n] for n, p in model.named_parameters()},
                    "buffers": {n: b.clone() for n, b in model.named_buffers()},
                    "gen": step.generator.get_state()})
    hook.remove()
    return out


@functools.lru_cache(maxsize=None)
def _pair(row: str):
    model = build_model(row, img_size=IMG, num_domains=D, device="cpu", seed=0,
                        drop_rate=DROP, drop_path_rate=DROP, **NARROW)
    return _run(copy.deepcopy(model), remat=False), _run(model, remat=True)


@pytest.mark.parametrize("row", ROWS)
def test_remat_losses_and_state_equal_the_plain_step(row):
    for plain, remat in zip(*_pair(row)):
        assert set(remat["metrics"]) == set(plain["metrics"])
        for k, v in plain["metrics"].items():
            assert torch.equal(remat["metrics"][k], v), k
        for name, v in plain["buffers"].items():
            assert torch.equal(remat["buffers"][name], v), name
        assert torch.equal(remat["gen"], plain["gen"])
    # dropout did draw: the generator moved in each step
    first, second = _pair(row)[0]
    assert not torch.equal(first["gen"], second["gen"])


@pytest.mark.parametrize("row", ROWS)
def test_remat_updates_equal_the_plain_step(row):
    for plain, remat in zip(*_pair(row)):
        num = sum(((remat["update"][n] - u) ** 2).sum() for n, u in plain["update"].items())
        den = sum((u ** 2).sum() for u in plain["update"].values())
        assert den > 0 and (num / den).sqrt() <= UPDATE_REL_TOL


@pytest.mark.parametrize("row", ROWS)
def test_remat_recomputes_the_forward_once_a_pull(row):
    plain, remat = _pair(row)
    assert [r["calls"] for r in plain] == [1, 1]
    assert [r["calls"] for r in remat] == [ROWS[row]] * 2


_jax_case = functools.lru_cache(maxsize=None)(
    lambda: train_case("MDViT_DSN", IMG, B, remat=True))


def test_remat_metrics_match_jax():
    want, _, _, got = _jax_case()
    check_metrics(want, got)


def test_remat_gradients_match_jax():
    want, _, grads, _ = _jax_case()
    check_gradients(want, grads)


def test_remat_batch_stats_match_jax():
    want, model, _, _ = _jax_case()
    check_batch_stats(want, model)


def test_config_remat_reaches_the_trainer_step(tmp_path):
    """``tpu.remat: true`` trains through the CLI (no refusal), and each
    train step checkpoints its forward."""
    cfg = {"device": "cpu", "debug": True,
           "data": {"img_size": 16, "synthetic": True, "name": ["isic2018", "PH2"],
                    "synthetic_sizes": {"isic2018": [4, 2], "PH2": [4, 2]}},
           "train": {"num_epochs": 1, "batch_size": 2}, "test": {"batch_size": 2},
           "model_kwargs": {"num_layers": [1, 1, 1, 1], "embed_dims": [8, 8, 8, 8],
                            "mlp_ratios": [1, 1, 1, 1], "num_heads": [8, 8, 8, 8]},
           "tpu": {"compute_dtype": "float32", "remat": True}}
    path = tmp_path / "remat.yml"
    path.write_text(json.dumps(cfg))
    with mock.patch.object(steps, "checkpoint", wraps=steps.checkpoint) as ckpt:
        trainer = cli.main(["--exp_name", "remat", "--model", "MDViT", "--config_yml",
                            str(path), "--exp_dir", str(tmp_path / "exp")])
    assert ckpt.call_count == trainer.step >= 1
    assert os.path.exists(tmp_path / "exp" / "test_results.csv")
