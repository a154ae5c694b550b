"""The port's whole-array losses, the extra loss family and flat AdamW
(``mdvit_tpu_torch/train/{losses,losses_extra,flat_optim}.py``) against the
JAX functions on the same seeded numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdvit_tpu.train import flat_optim as jfo
from mdvit_tpu.train import losses as jl
from mdvit_tpu.train import losses_extra as jle
from mdvit_tpu_torch.train import flat_optim as tfo
from mdvit_tpu_torch.train import losses as tl
from mdvit_tpu_torch.train import losses_extra as tle

torch.set_num_threads(2)


def _close(got, want, tol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _probs_target(seed=0, shape=(2, 16, 16, 1)):
    r = np.random.RandomState(seed)
    logits = (r.randn(*shape) * 3).astype(np.float32)
    probs = 1 / (1 + np.exp(-logits))
    probs[0, 0, 0, 0], probs[0, 0, 1, 0] = 0.0, 1.0  # BCELoss's −100 clamp
    target = (r.rand(*shape) > 0.5).astype(np.float32)
    return logits, probs.astype(np.float32), target


@pytest.mark.parametrize("name", ["dice_loss", "dice_loss_nonsquared", "iou_loss",
                                  "bce_loss", "entropy_loss"])
def test_prob_losses_match_jax(name):
    _, probs, target = _probs_target()
    if name == "entropy_loss":
        _close(tl.entropy_loss(torch.from_numpy(probs)), jl.entropy_loss(jnp.asarray(probs)))
        return
    got = getattr(tl, name)(torch.from_numpy(probs), torch.from_numpy(target))
    _close(got, getattr(jl, name)(jnp.asarray(probs), jnp.asarray(target)))


@pytest.mark.parametrize("name", ["bce_with_logits", "seg_loss_from_logits"])
def test_logit_losses_and_grads_match_jax(name):
    logits, _, target = _probs_target(1)
    x = torch.from_numpy(logits).requires_grad_()
    got = getattr(tl, name)(x, torch.from_numpy(target))
    (gx,) = torch.autograd.grad(got, x)
    jf = getattr(jl, name)
    want, wgrad = jax.value_and_grad(jf)(jnp.asarray(logits), jnp.asarray(target))
    _close(got, want)
    _close(gx, wgrad)


def test_seg_loss_sums_add_over_row_blocks():
    """The sums of row blocks, added, form the whole array's loss."""
    logits, _, target = _probs_target(2)
    parts = [tl.seg_loss_sums(torch.from_numpy(logits[:, r:r + 8]),
                              torch.from_numpy(target[:, r:r + 8])) for r in (0, 8)]
    _close(tl.seg_loss_from_sums(parts[0] + parts[1]),
           jl.seg_loss_from_logits(jnp.asarray(logits), jnp.asarray(target)))


def _pair(seed=3, shape=(2, 8, 8, 3)):
    r = np.random.RandomState(seed)
    return r.randn(*shape).astype(np.float32), r.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", ["softmax_dice_loss", "softmax_mse_loss",
                                  "softmax_kl_loss", "symmetric_mse_loss"])
def test_softmax_losses_and_grads_match_jax(name):
    """Values, and the gradients of Σ loss · c to both inputs (the detached
    target side takes none, as under JAX's stop_gradient)."""
    a, b = _pair()
    ta, tb = (torch.from_numpy(t).requires_grad_() for t in (a, b))
    got = getattr(tle, name)(ta, tb)
    jf = getattr(jle, name)
    want = jf(jnp.asarray(a), jnp.asarray(b))
    _close(got, want)
    c = np.asarray(np.random.RandomState(4).randn(*np.shape(want)), np.float32)
    ga, gb = torch.autograd.grad((got * torch.from_numpy(c)).sum(), (ta, tb),
                                 allow_unused=True, materialize_grads=True)
    wa, wb = jax.grad(lambda x, y: jnp.sum(jf(x, y) * c), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    _close(ga, wa)
    _close(gb, wb)


def test_entropy_loss_map_matches_jax():
    p = np.abs(np.random.RandomState(5).rand(2, 4, 4, 2)).astype(np.float32)
    _close(tle.entropy_loss_map(torch.from_numpy(p)), jle.entropy_loss_map(jnp.asarray(p)))


@pytest.mark.parametrize("name", ["compute_sdf01", "compute_sdf1_1", "compute_fore_dist"])
def test_sdf_maps_equal_jax(name):
    seg = np.zeros((3, 2, 24, 24), np.uint8)
    r = np.random.RandomState(6)
    seg[0, 1, 4:14, 6:18] = 1
    seg[1, 1] = r.rand(24, 24) > 0.6
    seg[1, 0] = 1 - seg[1, 1]
    # seg[2] stays empty: skipped
    np.testing.assert_array_equal(getattr(tle, name)(seg), getattr(jle, name)(seg))
    np.testing.assert_array_equal(getattr(tle, name)(seg[:, 1]), getattr(jle, name)(seg[:, 1]))


@pytest.mark.parametrize("name", ["aaai_sdf_loss", "sdf_kl_loss"])
def test_sdf_losses_and_grads_match_jax(name):
    r = np.random.RandomState(7)
    seg = np.zeros((2, 2, 16, 16), np.uint8)
    seg[:, 1, 3:11, 4:12] = 1
    seg[:, 0] = 1 - seg[:, 1]
    gt = (tle.compute_sdf1_1(seg) if name == "aaai_sdf_loss"
          else tle.compute_sdf01(seg)).astype(np.float32)
    out = r.randn(2, 2, 16, 16).astype(np.float32)
    if name == "sdf_kl_loss":
        out = np.log(np.abs(out) + 0.1).astype(np.float32)
    t_out = torch.from_numpy(out).requires_grad_()
    got = getattr(tle, name)(t_out, torch.from_numpy(gt))
    (g,) = torch.autograd.grad(got, t_out)
    want, wg = jax.value_and_grad(getattr(jle, name))(jnp.asarray(out), jnp.asarray(gt))
    _close(got, want)
    _close(g, wg)


@pytest.mark.parametrize("attribute", [False, True])
def test_supervised_contrastive_matches_jax(attribute):
    r = np.random.RandomState(8)
    z = r.randn(12, 16).astype(np.float32)
    tg = r.randint(0, 3, 12)
    at = r.randint(0, 2, 12) if attribute else None
    tz = torch.from_numpy(z).requires_grad_()
    got = tle.supervised_contrastive_loss(
        tz, torch.from_numpy(tg), None if at is None else torch.from_numpy(at))
    (g,) = torch.autograd.grad(got, tz)
    jf = lambda zz: jle.supervised_contrastive_loss(  # noqa: E731
        zz, jnp.asarray(tg), None if at is None else jnp.asarray(at))
    want, wg = jax.value_and_grad(jf)(jnp.asarray(z))
    _close(got, want, 2e-6)
    _close(g, wg, 2e-6)


@pytest.mark.parametrize("wd", [0.05, 0.0])
def test_flat_adamw_matches_jax_and_optax(wd):
    """Three updates with a callable schedule (evaluated at the
    pre-increment count) against JAX's ``flat_adamw`` and ``optax.adamw``."""
    r = np.random.RandomState(9)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [r.randn(*s).astype(np.float32) for s in shapes]
    grads = [[r.randn(*s).astype(np.float32) for s in shapes] for _ in range(3)]
    sched = lambda k: 1e-2 * 0.5 ** (k // 2)  # noqa: E731
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tfo.flat_adamw(tp, sched, weight_decay=wd)
    jp = [jnp.asarray(p) for p in params]
    op = [jnp.asarray(p) for p in params]
    jtx = jfo.flat_adamw(sched, weight_decay=wd)
    otx = optax.adamw(sched, weight_decay=wd)
    js, os_ = jtx.init(jp), otx.init(op)
    for g in grads:
        for p, gg in zip(tp, g):
            p.grad = torch.from_numpy(gg)
        opt.step()
        ju, js = jtx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, ju)
        ou, os_ = otx.update([jnp.asarray(x) for x in g], os_, op)
        op = optax.apply_updates(op, ou)
    assert opt.count == 3
    for t, a, b in zip(tp, jp, op):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
