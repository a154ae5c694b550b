"""The port's MKD train step of MDViT_DSN and of MDViT without the Sup gate
against the JAX package's, on the CPU (as tests/test_torch_family_train.py
for the BASE family): with det_sup on, MDViT_DSN's second pull takes its
``domain_layer`` gradients, and the gate-less MDViT has none to pull."""
import functools

import pytest
import torch

from torch_family import check_batch_stats, check_gradients, check_metrics, train_case

torch.set_num_threads(2)

IMG, B = 64, 2
ROWS = ["MDViT_DSN", "MDViT_noSup"]

_case = functools.lru_cache(maxsize=None)(lambda row: train_case(row, IMG, B))


@pytest.mark.parametrize("row", ROWS)
def test_metrics_match_jax(row):
    want, _, _, got = _case(row)
    check_metrics(want, got)


@pytest.mark.parametrize("row", ROWS)
def test_gradients_match_jax(row):
    want, _, grads, _ = _case(row)
    check_gradients(want, grads)


@pytest.mark.parametrize("row", ROWS)
def test_batch_stats_match_jax(row):
    want, model, _, _ = _case(row)
    check_batch_stats(want, model)
