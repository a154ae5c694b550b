"""The port's end-to-end context parallelism (``model_apply_context_parallel``,
``make_context_parallel_train_step``, ``make_dp_context_mesh``) on the CPU,
in gloo ranks (``tests/torch_cp.py``): JAX's tiny BASE of
``tests/test_context_parallel.py`` (img 64, dims 8/16/16/24, one layer a
stage, 8 heads, Sup) with the image rows over 2 ranks against JAX's
unsharded forward; the train-mode forward (dropout 0.3) and one train step
(AdamW) against the port's unsharded ones; what JAX's context parallelism
cannot run (``swin_tiny``'s forward, TransFuse's step) refused. MDViT's
forward is in ``test_torch_context_parallel_mdvit.py``, the (2, 2) grid in
``test_torch_context_parallel_grid.py``, the comparators in
``test_torch_context_parallel_zoo.py`` (a file each keeps ``--dist
loadfile``'s files short)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp
import torch_dp
from mdvit_tpu.models.base import BASE as JaxBASE
from mdvit_tpu_torch.convert import from_jax_variables

torch.set_num_threads(2)

IMG = 64
TINY = dict(num_layers=(1, 1, 1, 1), embed_dims=(8, 16, 16, 24), mlp_ratios=(2, 2, 2, 2),
            num_heads=(8, 8, 8, 8))
# tests/test_context_parallel.py's: the forward (fp32 sums in another order,
# logits up to ~1e3 at these weights), the step's loss and BN stats
FWD_TOL = dict(rtol=5e-4, atol=5e-4)
LOSS_RTOL = 1e-4
BN_TOL = dict(rtol=5e-4, atol=5e-5)


def _variables(model, batch: int, **kw):
    """flax init, every leaf perturbed (running var kept positive)."""
    x0 = jnp.zeros((batch, IMG, IMG, 3))
    oh0 = jnp.eye(4, dtype=jnp.float32)[np.arange(batch) % 4]
    variables = jax.jit(lambda k: model.init({"params": k, "dropout": k}, x0, oh0,
                                             train=False, **kw))(jax.random.PRNGKey(1))
    rs = np.random.RandomState(0)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        noise = rs.standard_normal(leaf.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return leaf * np.exp(0.2 * noise)
        return leaf + 0.02 * noise

    return jax.tree_util.tree_map_with_path(perturb, dict(variables))


def _data(batch: int, seed: int = 2):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((batch, IMG, IMG, 3)).astype(np.float32)
    y = (rs.rand(batch, IMG, IMG, 1) > 0.5).astype(np.float32)
    dom = np.eye(4, dtype=np.float32)[[1, 3, 0, 2][:batch]]
    return x, y, dom


def _spec(tmp_path, name: str, variables, x, y, dom, **extra):
    spec = {"model": dict(name=name, img_size=IMG, adapt_method="Sup", drop_rate=0.3,
                          drop_path_rate=0.3, **TINY),
            "state_dict": from_jax_variables(variables),
            "x": torch.from_numpy(x), "y": torch.from_numpy(y), "dom": torch.from_numpy(dom),
            **extra}
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    return spec, str(path)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _grads_close(got: dict, want: dict) -> None:
    """``test_context_parallel.py``'s gradient tolerance: fp32 order noise
    through the backward reaches ~2e-4 of a leaf's scale; 1e-6 covers leaves
    whose true gradient is ~0 (a conv bias feeding a BN)."""
    assert set(got) == set(want)
    for n, a in want.items():
        a = a.numpy()
        _close(got[n].numpy(), a, rtol=1e-3, atol=max(3e-4 * np.abs(a).max(), 1e-6),
               err_msg=n)


def _step_close(res: dict, ref: dict) -> None:
    _close(float(res["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)
    for n, a in ref["stats"].items():
        _close(res["stats"][n].numpy(), a.numpy(), err_msg=n, **BN_TOL)


def test_base_forward_and_step_on_two_ranks(tmp_path):
    """BASE with the rows over 2 ranks: the eval forward's ``seg`` and ``feat``
    against JAX unsharded; the train-mode forward (dropout and stochastic
    depth 0.3: the unsharded masks' rows) and one CP train step against the
    port's unsharded ones (loss, BN stats, gradients)."""
    model = JaxBASE(img_size=IMG, adapt="Sup", num_domains=4, **TINY)
    variables = _variables(model, 2)
    x, y, dom = _data(2)
    want = jax.jit(lambda v: model.apply(v, x, dom, train=False))(variables)
    spec, path = _spec(tmp_path, "BASE", variables, x, y, dom, train_forward=True, train=True)
    res = torch_dp.spawn(torch_cp.e2e_worker, 2, tmp_path, path, str(tmp_path / "out"))
    ref = {**torch_cp.forwards(spec, None), **torch_cp.train_step(spec, None)}
    for r in res:
        _close(r["seg"].numpy(), want["seg"], **FWD_TOL)
        _close(r["feat"].numpy(), want["feat"], **FWD_TOL)
        _close(r["train_seg"].numpy(), ref["train_seg"].numpy(), **FWD_TOL)
        _step_close(r, ref)
        _grads_close(r["grads"], ref["grads"])


@pytest.mark.parametrize("name", ["swin_tiny", "TransFuse_S"])
def test_other_models_raise(name):
    """What JAX's context parallelism cannot run is refused, naming the model:
    ``swin_tiny``'s forward (JAX's entry point passes the domain one-hot
    positionally, onto ``SwinClassifier``'s ``train``) and TransFuse's train
    step (its three deep-supervision maps; JAX's step casts the tuple)."""
    from mdvit_tpu_torch.models.registry import build_model
    from mdvit_tpu_torch.parallel.context import (make_context_parallel_train_step,
                                                  model_apply_context_parallel)

    if name == "swin_tiny":
        model = build_model(name, img_size=64, device="cpu", embed_dim=24, depths=(1, 1, 1, 1),
                            num_heads=(1, 1, 1, 1), num_classes=4)
        with pytest.raises(NotImplementedError, match=name):
            model_apply_context_parallel(model, torch.zeros(1, 64, 64, 3), None, None)
    else:
        model = build_model(name, img_size=64, device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        with pytest.raises(NotImplementedError, match="TransFuse.*map_x, map_1, map_2"):
            make_context_parallel_train_step(model, opt, None)
