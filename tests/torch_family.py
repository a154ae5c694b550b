"""Shared pieces of the port's model-family tests (``test_torch_family_*.py``,
``test_torch_dsn.py``): the ten configurations of the paper's comparisons,
seeded flax variables for a ``mdvit_tpu`` model, the port's counterpart
loaded with them, and one train step on each side."""
import contextlib
from unittest import mock

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import mdvit_tpu.models.decoders as jax_decoders
from mdvit_tpu.models.base import BASE as JaxBASE
from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu.ops.layers import Dropout2d as JaxDropout2d
from mdvit_tpu.train.steps import TrainState
from mdvit_tpu.train.steps import make_train_step as jax_make_train_step
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.train.optim import build_optimizer
from mdvit_tpu_torch.train.steps import make_train_step

# tests/test_torch_trainer.py's TINY_MODEL
TINY = dict(num_layers=(1, 1, 1, 1), embed_dims=(8, 8, 8, 8), mlp_ratios=(1, 1, 1, 1),
            num_heads=(8, 8, 8, 8))
D = 4
# tests/test_torch_train_step.py's tolerances: losses and dice/IoU; each
# gradient relative to its leaf's largest |grad|, with a floor for leaves
# whose true gradient is zero (cancellation noise on both sides)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_TOL = 1e-3
GRAD_ABS_FLOOR = 1e-5

# id → (registry name, adapt_method, decoder_name or None)
ROWS = {
    "BASE": ("BASE", None, None),
    "BASE_Sup": ("BASE", "Sup", None),
    "BASE_DSN": ("BASE_DSN", None, None),
    "BASE_DASE": ("BASE_DASE", None, None),
    "BASE_USE": ("BASE_USE", None, None),
    "MDViT_DSN": ("MDViT_DSN", "Sup", "MLPFM"),
    "MDViT_MLP": ("MDViT", "Sup", "MLP"),
    "MDViT_DeepLabV3": ("MDViT", "Sup", "DeepLabV3"),
    "MDViT_Transformer": ("MDViT", "Sup", "Transformer"),
    "MDViT_noSup": ("MDViT", None, "MLPFM"),
}


def is_mkd(row: str) -> bool:
    return ROWS[row][0].startswith("MDViT")


def widths(row: str) -> dict:
    """TINY; DASE at 16 channels, so that its SE layers (reduction 16) have
    a hidden unit."""
    return dict(TINY, embed_dims=(16, 16, 16, 16)) if row == "BASE_DASE" else dict(TINY)


def jax_model(row: str, img: int, num_domains: int = D):
    """The flax module of ``row``, dropout and stochastic depth 0 (the
    JAX builders fix them at 0.1, drawn from threefry, which the port's
    hashed masks cannot match)."""
    name, adapt, decoder = ROWS[row]
    kw = dict(img_size=img, num_domains=num_domains, adapt="Sup" if adapt else None,
              dsn=name.endswith("DSN"), **widths(row))
    if name.startswith("MDViT"):
        return JaxMDViT(decoder_name=decoder, **kw)
    return JaxBASE(adapter={"BASE_DASE": "DASE", "BASE_USE": "USE"}.get(name), **kw)


def port_model(row: str, variables, img: int, num_domains: int = D):
    """The port's registry model of ``row`` on the CPU, dropout off, with
    ``variables`` loaded (strict: every key mapped, none missing)."""
    name, adapt, decoder = ROWS[row]
    kw = dict(widths(row), decoder_name=decoder) if decoder else widths(row)
    model = build_model(name, img_size=img, num_domains=num_domains, adapt_method=adapt,
                        device="cpu", drop_rate=0.0, drop_path_rate=0.0, **kw)
    model.load_state_dict(from_jax_variables(variables))
    for m in model.modules():  # the debranches' own dropouts
        if hasattr(m, "dropout_ratio"):
            m.dropout_ratio = 0.0
    return model


def onehot(domains) -> np.ndarray:
    return np.eye(D, dtype=np.float32)[np.asarray(domains)]


def init_kw(model) -> dict:
    """MDViT inits with every debranch (``aux_mode="grouped"``)."""
    return {"aux_mode": "grouped"} if isinstance(model, JaxMDViT) else {}


def random_variables(model, x, oh, seed: int = 0, call_kw: dict | None = None):
    """Seeded variables of ``model``'s init tree (its shapes from
    ``jax.eval_shape``, so nothing compiles): kernels normal(0, 1/√fan_in),
    norm scales 1 + 0.1·n, biases and means 0.1·n, running variances
    exp(0.2·n), n ~ N(0, 1) from a numpy RandomState. ``call_kw``: the
    init call's keywords (default: eval mode, every debranch)."""
    kw = {"train": False, **init_kw(model)} if call_kw is None else call_kw
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k, "dropout": k}, x, oh, **kw), jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        n = rs.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if key == "var":
            return np.exp(0.2 * n)
        if key == "scale":
            return 1.0 + 0.1 * n
        if key in ("bias", "mean") or key.startswith("b") and len(key) == 2:
            return 0.1 * n
        # conv HWIO (stacked: D, H, W, I, O), dense (in, out), CRPE w3/w5/w7
        fan_in = int(np.prod(leaf.shape[-4:-1] if leaf.ndim >= 4 else leaf.shape[-2:-1]))
        return n / np.sqrt(fan_in)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def stores(rs, img: int, n: int = 3, d: int = D):
    images = [rs.randint(0, 256, (n, img, img, 3)).astype(np.uint8) for _ in range(d)]
    masks = [(rs.rand(n, img, img) > 0.5).astype(np.uint8) for _ in range(d)]
    return images, masks


@contextlib.contextmanager
def no_debranch_dropout():
    """The JAX debranches' dropouts at rate 0: ``Dropout2d`` of the MLP
    decoders and the ASPP's flax ``nn.Dropout`` (threefry masks)."""
    dropout = flax_nn.Dropout
    with mock.patch.object(jax_decoders, "Dropout2d",
                           lambda rate, name: JaxDropout2d(0.0, name=name)), \
            mock.patch.object(flax_nn, "Dropout", lambda rate, **kw: dropout(0.0, **kw)):
        yield


def jax_step(model, variables, data, mkd: bool, num_domains: int = D, remat: bool = False):
    """One JAX train step (``make_train_step(device_augment=False)``) with
    ``optax.sgd(1.0)``: the gradients are the parameters' change. Returns
    grads and new batch stats in port names, and the metrics."""
    images, masks, indices = data
    tx = optax.sgd(1.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(1))
    step = jax_make_train_step(model, tx, num_domains, mkd=mkd, device_augment=False,
                               donate=False, remat=remat)
    with no_debranch_dropout():
        new_state, metrics = step(state, tuple(map(jnp.asarray, images)),
                                  tuple(map(jnp.asarray, masks)), jnp.asarray(indices))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   state.params, new_state.params)
    return {"grads": from_jax_variables({"params": grads}),
            "batch_stats": from_jax_variables({"batch_stats": new_state.batch_stats}),
            "metrics": {k: np.asarray(v) for k, v in metrics.items()}}


def port_step(model, data, mkd: bool, num_domains: int = D, **kw):
    """One port train step; returns each parameter's gradient and the metrics."""
    images, masks, indices = data
    opt, sched = build_optimizer(model, steps_per_epoch=10)
    metrics = make_train_step(model, opt, sched, num_domains, mkd=mkd,
                              device_augment=False, **kw)(
        [torch.from_numpy(a) for a in images], [torch.from_numpy(a) for a in masks],
        torch.from_numpy(np.asarray(indices)).long())
    return {n: p.grad.clone() for n, p in model.named_parameters()}, metrics


def check_metrics(want: dict, got: dict) -> None:
    assert set(got) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **LOSS_TOL)


def check_gradients(want: dict, grads: dict) -> None:
    assert set(grads) == set(want["grads"])
    worst = 0.0
    for name, g in grads.items():
        w = want["grads"][name].numpy()
        if not w.size:
            continue
        err = np.abs(g.numpy() - w).max()
        limit = max(GRAD_REL_TOL * np.abs(w).max(), GRAD_ABS_FLOOR)
        assert err <= limit, (name, err, np.abs(w).max())
        worst = max(worst, err / limit)
    assert worst > 0  # the comparison saw real differences, not one tensor twice


def check_batch_stats(want: dict, model: torch.nn.Module) -> None:
    """Running stats after the step, the per-domain ones of DSN too."""
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want["batch_stats"])
    for name, v in want["batch_stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), err_msg=name,
                                   **LOSS_TOL)


def train_case(row: str, img: int, b: int, d: int = D, seed: int = 1, remat: bool = False):
    """One train step of ``row`` on both sides from the same variables and
    batch (``b`` per domain), with activation recomputation on both when
    ``remat``: the JAX results, the port's model after its step, its
    gradients and its metrics."""
    rs = np.random.RandomState(seed)
    images, masks = stores(rs, img, d=d)
    data = (images, masks, rs.randint(0, 3, (d, b)).astype(np.int32))
    model = jax_model(row, img, num_domains=d)
    oh = jnp.repeat(jnp.eye(d, dtype=jnp.float32), b, 0)
    variables = random_variables(model, jnp.zeros((d * b, img, img, 3)), oh)
    want = jax_step(model, variables, data, is_mkd(row), num_domains=d, remat=remat)
    port = port_model(row, variables, img, num_domains=d)
    grads, metrics = port_step(port, data, is_mkd(row), num_domains=d, remat=remat)
    return want, port, grads, metrics
