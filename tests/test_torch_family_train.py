"""The port's train step of the BASE family against the JAX package's, on
the CPU.

One step of ``make_train_step(device_augment=False)`` on each side from the
same seeded variables (tests/torch_family.py), at the tiny widths of
tests/test_torch_trainer.py, img 64, B = 2 per domain, the single objective
(mkd off): BASE, BASE_DSN, BASE_DASE, BASE_USE, and BASE+Sup at D = 15
(tests/test_multidomain_dc.py). Dropout and stochastic depth at 0 on both
sides; fp32, JAX at ``highest``; tests/test_torch_train_step.py's
tolerances. MDViT_DSN and MDViT without the gate: test_torch_family_train_mkd.py.
"""
import functools

import pytest
import torch

from torch_family import check_batch_stats, check_gradients, check_metrics, train_case

torch.set_num_threads(2)

IMG, B = 64, 2
# (row id, number of domains)
CASES = [("BASE", 4), ("BASE_DSN", 4), ("BASE_DASE", 4), ("BASE_USE", 4), ("BASE_Sup", 15)]
IDS = ["BASE", "BASE_DSN", "BASE_DASE", "BASE_USE", "BASE_Sup_D15"]

_case = functools.lru_cache(maxsize=None)(lambda row, d: train_case(row, IMG, B, d))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_metrics_match_jax(case):
    want, _, _, got = _case(*case)
    check_metrics(want, got)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_match_jax(case):
    want, _, grads, _ = _case(*case)
    check_gradients(want, grads)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batch_stats_match_jax(case):
    want, model, _, _ = _case(*case)
    check_batch_stats(want, model)


def test_sup_gate_conditions_on_15_domains():
    """At D = 15 every gate takes the 15-wide one-hot, and the step moves it."""
    _, model, grads, _ = _case("BASE_Sup", 15)
    gates = [n for n in grads if n.endswith("domain_layer.0.weight")]
    assert len(gates) == 8
    for n in gates:
        assert model.get_parameter(n).shape[1] == 15 and grads[n].abs().max() > 0
