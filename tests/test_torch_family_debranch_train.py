"""The port's MKD train step with the DeepLabV3 and the Transformer
debranches (MDViT^D, MDViTᵀ) against the JAX package's, and MDViTᵀ's eval
step, on the CPU.

As tests/test_torch_family_train.py: one step of
``make_train_step(device_augment=False)`` on each side from the same seeded
variables, tiny widths, img 64, B = 2 per domain, fp32, JAX at
``highest``, tests/test_torch_train_step.py's tolerances. The ASPP's
dropout is flax's ``nn.Dropout(0.1)``, drawn from threefry, which the
port's hashed masks cannot match: both sides run it at rate 0 for the step
(``torch_family.no_debranch_dropout``; the port's ``dropout_ratio``).
The Transformer debranch's second (``domain_layer``) pull runs through the
debranches: the KT loss reads the aux logits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.train.steps import make_eval_step as jax_make_eval_step
from mdvit_tpu_torch.train.steps import make_eval_step
from torch_family import (check_batch_stats, check_gradients, check_metrics, jax_model,
                          onehot, port_model, random_variables, train_case)

torch.set_num_threads(2)

IMG, B = 64, 2
ROWS = ["MDViT_DeepLabV3", "MDViT_Transformer"]
# eval losses and overlap counts: the forwards sum in another order
REL_TOL = 1e-4

_case = functools.lru_cache(maxsize=None)(lambda row: train_case(row, IMG, B))


@pytest.mark.parametrize("row", ROWS)
def test_metrics_match_jax(row):
    want, _, _, got = _case(row)
    check_metrics(want, got)


@pytest.mark.parametrize("row", ROWS)
def test_gradients_match_jax(row):
    want, _, grads, _ = _case(row)
    check_gradients(want, grads)
    # the KT loss carries the second pull through the debranches' attention
    if row == "MDViT_Transformer":
        assert grads["debranch1.decoder1.mhsa_block.mhca_blks.0.factoratt_crpe.qkv.weight"
                     ].abs().max() > 0


@pytest.mark.parametrize("row", ROWS)
def test_batch_stats_match_jax(row):
    want, model, _, _ = _case(row)
    check_batch_stats(want, model)


@pytest.mark.parametrize("domain", [0, 3])
def test_transformer_eval_step_matches_jax(domain):
    """MDViTᵀ's eval step on a padded single-domain batch (3 valid of 4):
    the masked loss and the primary and aux overlap counts."""
    model = jax_model("MDViT_Transformer", 32)
    variables = random_variables(model, jnp.zeros((4, 32, 32, 3)),
                                 jnp.asarray(onehot([0, 1, 2, 3])), seed=5)
    port = port_model("MDViT_Transformer", variables, 32)
    rs = np.random.RandomState(6)
    imgs = rs.uniform(0, 255, (4, 32, 32, 3)).astype(np.float32)
    msks = (rs.rand(4, 32, 32) > 0.5).astype(np.float32)
    oh = onehot([domain] * 4)
    aux_vars = {c: jax.tree_util.tree_map(lambda a: a[domain], variables[c]["debranch"])
                for c in ("params", "batch_stats")}
    want = jax.jit(jax_make_eval_step(model, mkd=True))(
        variables["params"], variables["batch_stats"], imgs, msks, oh, jnp.int32(3),
        aux_vars=aux_vars)
    got = make_eval_step(port, mkd=True)(torch.from_numpy(imgs), torch.from_numpy(msks),
                                         torch.from_numpy(oh), 3, domain=domain)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=REL_TOL)
    for head in ("primary", "aux"):
        for k, v in want[head].items():
            np.testing.assert_allclose(got[head][k].item(), float(v), rtol=REL_TOL,
                                       err_msg=f"{head}/{k}")
