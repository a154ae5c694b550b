"""The port's 4-domain MKD train step against the JAX package's, on the CPU.

A narrow MDViT (dims 16/32/40/64, 8 heads, one block per stage, Sup gate,
MLPFM debranches, 4 domains, img 64, B = 2 per domain): JAX init, every
parameter and BN stat perturbed from a seeded numpy RandomState, carried into
the port by ``from_jax_variables``. Dropout and stochastic depth at 0 on both
sides (the debranch's ``Dropout2d(0.1)`` too: JAX's threefry masks cannot be
matched), fp32, JAX at ``highest`` precision.

JAX's gradients come from one run of its step with ``optax.sgd(1.0)``
(Δparams = −grads), which needs no change to the JAX package.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mdvit_tpu.models.decoders as jax_decoders
from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu.ops.layers import Dropout2d as JaxDropout2d
from mdvit_tpu.train.steps import TrainState
from mdvit_tpu.train.steps import make_train_step as jax_make_train_step
from mdvit_tpu_torch.convert import _torch_name, from_jax_variables
from mdvit_tpu_torch.data.loader import eval_transform, gather_batch
from mdvit_tpu_torch.models.registry import build_mdvit
from mdvit_tpu_torch.train.optim import build_optimizer
from mdvit_tpu_torch.train.steps import make_train_step, per_domain_losses

torch.set_num_threads(2)

# img 64 puts the bridge at 2×2: at img 32 its per-domain BN takes moments
# of 2 values and magnifies last-bit differences into 3e-3 of its gradients
IMG, D, B = 64, 4, 2
NARROW = dict(num_layers=(1, 1, 1, 1), embed_dims=(16, 32, 40, 64))
# losses and dice/IoU: the forwards sum in another order (REL_TOL of
# test_torch_mdvit.py is 1e-4 on logits); the losses are O(1) sums of them
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
# gradients, per leaf, relative to the leaf's largest |grad|: the backward
# chains as many fp32 sums as the forward, twice over (two pulls)
GRAD_REL_TOL = 1e-3
# ... with a floor for leaves whose true gradient is zero (a conv bias ahead
# of a BatchNorm): both sides then hold cancellation noise of the size of the
# rounding of the loss's O(1) terms
GRAD_ABS_FLOOR = 1e-5


def _stores(rs):
    images = [rs.randint(0, 256, (3, IMG, IMG, 3)).astype(np.uint8) for _ in range(D)]
    masks = [(rs.rand(3, IMG, IMG) > 0.5).astype(np.uint8) for _ in range(D)]
    return images, masks


@pytest.fixture(scope="module")
def setup():
    model = JaxMDViT(img_size=IMG, adapt="Sup", num_domains=D, **NARROW)
    x0 = jnp.zeros((D * B, IMG, IMG, 3))
    oh0 = jnp.repeat(jnp.eye(D, dtype=jnp.float32), B, 0)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x0, oh0, train=False,
        aux_mode="grouped"))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        noise = rs.standard_normal(leaf.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return leaf * np.exp(0.2 * noise)
        return leaf + 0.02 * noise

    variables = jax.tree_util.tree_map_with_path(perturb, dict(variables))
    images, masks = _stores(np.random.RandomState(1))
    indices = np.array([[0, 2], [1, 0], [2, 2], [1, 1]], np.int32)

    tx = optax.sgd(1.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(1))
    step = jax_make_train_step(model, tx, D, device_augment=False, donate=False)
    no_debranch_dropout = lambda rate, name: JaxDropout2d(0.0, name=name)  # noqa: E731
    with mock.patch.object(jax_decoders, "Dropout2d", no_debranch_dropout):
        new_state, metrics = step(state, tuple(map(jnp.asarray, images)),
                                  tuple(map(jnp.asarray, masks)), jnp.asarray(indices))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   state.params, new_state.params)
    want = {"grads": from_jax_variables({"params": grads}),
            "batch_stats": from_jax_variables({"batch_stats": new_state.batch_stats}),
            "metrics": {k: np.asarray(v) for k, v in metrics.items()}}
    return variables, (images, masks, indices), want


def _port_model(variables):
    model = build_mdvit(img_size=IMG, num_domains=D, device="cpu", drop_rate=0.0,
                        drop_path_rate=0.0, **NARROW)
    model.load_state_dict(from_jax_variables(variables))
    for d in range(1, D + 1):
        getattr(model, f"debranch{d}").dropout_ratio = 0.0
    return model


def _batch(data):
    images, masks, indices = data
    return ([torch.from_numpy(a) for a in images], [torch.from_numpy(a) for a in masks],
            torch.from_numpy(indices).long())


@pytest.fixture(scope="module")
def port_step(setup):
    variables, data, _ = setup
    model = _port_model(variables)
    opt, sched = build_optimizer(model, steps_per_epoch=10)
    metrics = make_train_step(model, opt, sched, D, device_augment=False)(*_batch(data))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return model, grads, metrics


def test_metrics_match_jax(setup, port_step):
    _, _, want = setup
    _, _, got = port_step
    assert set(got) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **LOSS_TOL)


def test_gradients_match_jax(setup, port_step):
    _, _, want = setup
    _, grads, _ = port_step
    assert set(grads) == set(want["grads"])
    worst = 0.0
    for name, g in grads.items():
        w = want["grads"][name].numpy()
        err = np.abs(g.numpy() - w).max()
        limit = max(GRAD_REL_TOL * np.abs(w).max(), GRAD_ABS_FLOOR)
        assert err <= limit, (name, err, np.abs(w).max())
        worst = max(worst, err / limit)
    assert worst > 0  # the comparison saw real differences, not one tensor twice


def test_batch_stats_match_jax(setup, port_step):
    _, _, want = setup
    model, _, _ = port_step
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want["batch_stats"])
    for name, v in want["batch_stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), err_msg=name,
                                   **LOSS_TOL)


def test_the_step_moves_params_by_adamw(setup, port_step):
    """The first AdamW update is lr·g/(|g|+ε) plus the decay: at most lr
    (1e-4) plus lr·0.05·|p| away from where each parameter started, give or
    take the rounding of p itself (2⁻²³·|p| per step, two steps)."""
    variables, _, _ = setup
    model, _, _ = port_step
    start = from_jax_variables({"params": variables["params"]})
    moved = 0
    for name, p in model.named_parameters():
        delta = (p.detach() - start[name]).abs()
        bound = 1e-4 * (1 + 0.05 * start[name].abs()) + 2.4e-7 * (1 + start[name].abs())
        assert (delta <= bound).all(), name
        moved += int((delta > 0).any())
    assert moved > 0


def test_mkd_mask_on_the_port(setup, port_step):
    """domain_layer grads are exactly ∂L_uni; every other grad is
    ∂(L_aux + L_uni) = ∂L_aux + ∂L_uni (steps.py:223-245)."""
    variables, data, _ = setup
    _, grads, _ = port_step
    model = _port_model(variables)
    x_raw, m_raw, onehot = gather_batch(*_batch(data))
    x, y = eval_transform(x_raw, m_raw)
    logits, aux_logits = model(x, onehot, train=True, aux_mode="grouped")["seg"]
    seg_d, aux_d, kt_d, _, _ = per_domain_losses(logits, aux_logits, y, D)
    uni = 0.5 * kt_d.sum() + 0.5 * seg_d.sum()
    names, params = zip(*model.named_parameters())
    g_uni = torch.autograd.grad(uni, params, retain_graph=True, materialize_grads=True,
                                allow_unused=True)
    g_aux = torch.autograd.grad(aux_d.sum(), params, materialize_grads=True,
                                allow_unused=True)
    saw_aux_into_gate = False
    for name, gu, ga in zip(names, g_uni, g_aux):
        if "domain_layer" in name:
            np.testing.assert_array_equal(grads[name].numpy(), gu.numpy())
            saw_aux_into_gate |= bool(ga.abs().max() > 0)
        else:
            limit = max(GRAD_REL_TOL * (gu + ga).abs().max().item(), GRAD_ABS_FLOOR)
            assert (grads[name] - gu - ga).abs().max().item() <= limit, name
    assert saw_aux_into_gate  # the mask masks something real


@pytest.mark.parametrize("det_sup,mkd", [(False, True), (True, False)],
                         ids=["det_sup_off", "mkd_off"])
def test_step_variants_on_the_port(setup, det_sup, mkd):
    """det_sup off: every grad, domain_layer's too, is ∂(L_aux + L_uni).
    mkd off: the BASE objective, grads of Σ seg losses; the debranches,
    unused, get zero grads (as JAX's vjp gives them)."""
    variables, data, _ = setup
    model = _port_model(variables)
    opt, sched = build_optimizer(model, steps_per_epoch=10)
    make_train_step(model, opt, sched, D, det_sup=det_sup, mkd=mkd,
                    device_augment=False)(*_batch(data))
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    ref = _port_model(variables)
    x_raw, m_raw, onehot = gather_batch(*_batch(data))
    x, y = eval_transform(x_raw, m_raw)
    logits, aux_logits = ref(x, onehot, train=True,
                             aux_mode="grouped" if mkd else "none")["seg"]
    if mkd:
        seg_d, aux_d, kt_d, _, _ = per_domain_losses(logits, aux_logits, y, D)
        loss = aux_d.sum() + 0.5 * kt_d.sum() + 0.5 * seg_d.sum()
    else:
        loss = per_domain_losses(logits, logits, y, D)[0].sum()
    names, params = zip(*ref.named_parameters())
    want = torch.autograd.grad(loss, params, materialize_grads=True, allow_unused=True)
    for name, w in zip(names, want):
        limit = max(GRAD_REL_TOL * w.abs().max().item(), GRAD_ABS_FLOOR)
        assert (got[name] - w).abs().max().item() <= limit, name
        if not mkd and name.startswith("debranch"):
            assert not got[name].any(), name


def test_converted_names_cover_the_model(setup):
    """Every parameter and buffer of the port has a flax counterpart."""
    variables, _, _ = setup
    sd = from_jax_variables(variables)
    model = _port_model(variables)
    assert set(sd) == set(model.state_dict())
    assert _torch_name("core/stem1/conv/kernel") == "stem.0.conv.weight"
