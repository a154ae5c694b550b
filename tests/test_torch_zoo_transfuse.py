"""The port's TransFuse family, its deep-supervision step and
``structure_loss`` against the JAX package's, on the CPU.

tests/test_comparators.py's TransFuse_S at img 32 (± the Sup gate) and 32×64
(tests/torch_zoo.py), the same seeded variables and inputs on both sides,
fp32, JAX at ``highest``: every map of the eval forward within
1e-4·max(1, max|ref|); the eval step's counts and loss on map_2.

One train step (dropout 0) of TransFuse_S and TransFuse_S_adapt at img 64:
losses, per-domain dice and IoU and BN running stats at
tests/torch_family.py's tolerances. The gradients are held as a whole, by
their relative L2 norm: TransFuse's ReLUs and max-pools route a gradient by
the sign or the order of values, and fp32 rounding in another order flips a
few of them (values within a rounding step of 0 or of each other), moving
single leaves by percents. ``test_train_step_gradient_gap_is_fp32_rounding``
measures it against the same step in fp64 (relative L2 over all
gradients, TransFuse_S, on the CPU): the port's fp32 gradients 5.0e-3
from it, JAX's 1.8e-3, the two 5.1e-3 apart; the port's fp64 gradient
agrees with JAX's to JAX's own fp32 noise. The limit is four times the gap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.train.losses import structure_loss as jax_structure_loss
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.models.transfuse import TransFuse
from mdvit_tpu_torch.train.losses import structure_loss
from torch_family import LOSS_TOL, check_batch_stats, check_metrics
from torch_zoo import (case, check_maps, eval_counts, eval_forwards, onehot, port_grads_fp64,
                       rel_l2, train_case)

torch.set_num_threads(2)

GRAD_L2_TOL = 2e-2
TRAIN = ["TransFuse_S_64", "TransFuse_S_adapt_64"]


@pytest.mark.parametrize("cid", ["TransFuse_S", "TransFuse_S_adapt", "TransFuse_S_32x64"])
def test_eval_forward_matches_jax(cid):
    want, got, want_feat, got_feat = eval_forwards(cid)
    assert len(got) == 3 and all(m.shape[1:3] == want[0].shape[1:3] for m in got)
    check_maps(want, got)
    check_maps([want_feat], [got_feat])


def test_sup_gate_conditions_on_the_domain():
    _, _, port = case("TransFuse_S_adapt")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a = port(x, torch.from_numpy(onehot([1, 1])))["seg"][2]
        b = port(x, torch.from_numpy(onehot([3, 3])))["seg"][2]
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("cid", TRAIN)
def test_train_step_metrics_match_jax(cid):
    want, _, _, got = train_case(cid)
    check_metrics(want, got)


@pytest.mark.parametrize("cid", TRAIN)
def test_train_step_batch_stats_match_jax(cid):
    want, model, _, _ = train_case(cid)
    check_batch_stats(want, model)


@pytest.mark.parametrize("cid", TRAIN)
def test_train_step_gradients_match_jax(cid):
    want, _, grads, _ = train_case(cid)
    assert set(grads) == set(want["grads"])
    assert 0 < rel_l2(grads, want["grads"]) <= GRAD_L2_TOL
    gates = [n for n in grads if "domain_layer" in n]
    assert len(gates) == (32 if "adapt" in cid else 0)
    assert all(grads[n].abs().max() > 0 for n in gates)


def test_train_step_gradient_gap_is_fp32_rounding():
    """The gap between JAX's and the port's fp32 gradients is that of either
    to the exact gradient (the port's step in fp64): JAX's is no further
    from it than twice the port's, and the port's own fp32 gap is of the
    same size as the gap to JAX."""
    want, _, grads, _ = train_case("TransFuse_S_64")
    exact = port_grads_fp64("TransFuse_S_64")
    port_gap = rel_l2(grads, exact)
    jax_gap = rel_l2({n: torch.as_tensor(g) for n, g in want["grads"].items()}, exact)
    assert 0 < port_gap <= GRAD_L2_TOL / 2
    assert jax_gap <= 2 * port_gap
    assert rel_l2(grads, want["grads"]) <= 2 * port_gap


def test_eval_counts_take_map_2():
    want, got = eval_counts("TransFuse_S")
    np.testing.assert_allclose(got["loss"].item(), want["loss"], **LOSS_TOL)
    for k, v in want["primary"].items():
        assert got["primary"][k].item() == pytest.approx(float(v), rel=1e-6), k
    assert "aux" not in got


def test_structure_loss_matches_jax():
    """Value and gradient on random logits and masks, NHWC, non-square."""
    rs = np.random.RandomState(0)
    logits = (3 * rs.standard_normal((3, 40, 48, 1))).astype(np.float32)
    mask = (rs.rand(3, 40, 48, 1) > 0.5).astype(np.float32)
    want, want_g = jax.value_and_grad(jax_structure_loss)(jnp.asarray(logits),
                                                           jnp.asarray(mask))
    lt = torch.from_numpy(logits).requires_grad_()
    got = structure_loss(lt, torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(want_g)).max())


def test_transfuse_l_384_geometry():
    """``TransFuse_L_384`` is pinned to 384×512 whatever ``img_size`` says:
    DeiT-base's position embedding at the (24, 32) grid, resnet50's layer3
    at 1024 channels (built on the meta device, not run)."""
    model = build_model("TransFuse_L_384", img_size=256, device="meta")
    assert isinstance(model, TransFuse) and model.img_size == (384, 512)
    assert tuple(model.transformer.pos_embed.shape) == (1, 24 * 32, 768)
    assert model.resnet.layer3_0.conv3.out_channels == 1024
    assert model.up_c.residual.conv3.conv.out_channels == 1024
