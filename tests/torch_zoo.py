"""Shared pieces of the comparator tests (``test_torch_zoo_*.py``): the tiny
configurations of tests/test_comparators.py on each side, seeded flax
variables (tests/torch_family.py's draws) carried into the port by
``convert.from_jax_variables`` (held to the model), the eval forward of
both, and one train step on each side.

Dropout and stochastic depth are 0 on both sides: JAX draws its masks from
threefry, which the port's hashed masks cannot match."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mdvit_tpu.models.swin_unet import SwinUnet as JaxSwinUnet
from mdvit_tpu.models.swin_unetr import SwinUNETR as JaxSwinUNETR
from mdvit_tpu.models.transfuse import TransFuse as JaxTransFuse
from mdvit_tpu.models.utnet import UTNet as JaxUTNet
from mdvit_tpu.train.steps import make_eval_step as jax_make_eval_step
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.train.steps import make_eval_step
from torch_family import jax_step, port_step, random_variables, stores

D = 4
SWIN = dict(img_size=32, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window=4,
            drop_path_rate=0.0)
SWINUNETR = dict(img_size=32, feature_size=4, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                 window=4)
UTNET = dict(base_chan=4, reduce_size=2, num_heads=(2, 2, 2, 2), attn_drop=0.0, proj_drop=0.0)

# case id → (flax module, registry name, the port's builder keywords, (H, W))
CASES = {
    "SwinUnet": (lambda: JaxSwinUnet(**SWIN), "SwinUnet", SWIN, (32, 32)),
    "SwinUNETR": (lambda: JaxSwinUNETR(**SWINUNETR), "SwinUNETR", SWINUNETR, (32, 32)),
    "UTNet": (lambda: JaxUTNet(**UTNET), "UTNet", UTNET, (32, 32)),
    "TransFuse_S": (lambda: JaxTransFuse(img_size=32, variant="S", drop_rate=0.0),
                    "TransFuse_S", dict(img_size=32, drop_rate=0.0), (32, 32)),
    "TransFuse_S_adapt": (lambda: JaxTransFuse(img_size=32, variant="S", sup=True,
                                               drop_rate=0.0),
                          "TransFuse_S_adapt", dict(img_size=32, drop_rate=0.0), (32, 32)),
    "TransFuse_S_32x64": (lambda: JaxTransFuse(img_size=(32, 64), variant="S", drop_rate=0.0),
                          "TransFuse_S", dict(img_size=(32, 64), drop_rate=0.0), (32, 64)),
    # the train step's: at img 32 ResNet layer2 is 4×4, where BatchNorm's
    # E[x²] − E[x]² of post-ReLU convs cancels and each side's sums in their
    # own order move the gradients by percents; at 64 they agree to 1e-5
    "TransFuse_S_64": (lambda: JaxTransFuse(img_size=64, variant="S", drop_rate=0.0),
                       "TransFuse_S", dict(img_size=64, drop_rate=0.0), (64, 64)),
    "TransFuse_S_128": (lambda: JaxTransFuse(img_size=128, variant="S", drop_rate=0.0),
                        "TransFuse_S", dict(img_size=128, drop_rate=0.0), (128, 128)),
    "TransFuse_S_adapt_64": (lambda: JaxTransFuse(img_size=64, variant="S", sup=True,
                                                  drop_rate=0.0),
                             "TransFuse_S_adapt", dict(img_size=64, drop_rate=0.0), (64, 64)),
}


def onehot(domains) -> np.ndarray:
    return np.eye(D, dtype=np.float32)[np.asarray(domains)]


@functools.lru_cache(maxsize=None)
def case(cid: str, seed: int = 0):
    """(flax module, its seeded variables, the port model loaded with them)."""
    make, name, kw, (h, w) = CASES[cid]
    model = make()
    x = jnp.zeros((D * 2, h, w, 3))
    oh = jnp.repeat(jnp.eye(D, dtype=jnp.float32), 2, 0)
    variables = {"batch_stats": {},  # none in a model of LayerNorms alone
                 **random_variables(model, x, oh, seed=seed, call_kw={"train": False})}
    port = build_model(name, num_domains=D, device="cpu", **kw)
    port.load_state_dict(from_jax_variables(variables, port))
    return model, variables, port


def eval_forwards(cid: str, seed: int = 1):
    """Both sides' eval forward of one batch of 4 normal images, one of each
    domain: (JAX maps, port maps, JAX feat, port feat) as numpy."""
    model, variables, port = case(cid)
    h, w = CASES[cid][3]
    x = np.random.RandomState(seed).standard_normal((4, h, w, 3)).astype(np.float32)
    oh = onehot([0, 1, 2, 3])
    ref = jax.jit(lambda v, x, o: model.apply(v, x, o, train=False))(variables, x, oh)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(oh))

    def maps(seg):
        return [np.asarray(m) for m in (seg if isinstance(seg, tuple) else (seg,))]

    return (maps(ref["seg"]), maps(out["seg"]), np.asarray(ref["feat"]),
            out["feat"].numpy())


def check_maps(want, got) -> None:
    """Every map within 1e-4·max(1, max|want|)."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()))


@functools.lru_cache(maxsize=None)
def train_case(cid: str, b: int = 2, seed: int = 1):
    """One train step of ``cid`` on both sides from the same variables and
    batch (``b`` a domain): the JAX results, the port's model after its
    step, its gradients and its metrics."""
    model, variables, _ = case(cid)
    h, w = CASES[cid][3]
    rs = np.random.RandomState(seed)
    images, masks = stores(rs, h)
    data = (images, masks, rs.randint(0, 3, (D, b)).astype(np.int32))
    want = jax_step(model, variables, data, mkd=False)
    _, name, kw, _ = CASES[cid]
    port = build_model(name, num_domains=D, device="cpu", **kw)
    port.load_state_dict(from_jax_variables(variables, port))
    grads, metrics = port_step(port, data, mkd=False)
    return want, port, grads, metrics


def eval_counts(cid: str, seed: int = 2):
    """Both sides' eval step (masked counts and loss) on a padded batch of 4
    of domain 1 with 3 valid rows."""
    model, variables, port = case(cid)
    h, w = CASES[cid][3]
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (4, h, w, 3)).astype(np.float32)
    masks = (rs.rand(4, h, w) > 0.5).astype(np.float32)
    oh = onehot([1] * 4)
    want = jax_make_eval_step(model, mkd=False)(
        variables["params"], variables["batch_stats"], jnp.asarray(images),
        jnp.asarray(masks), jnp.asarray(oh), 3)
    got = make_eval_step(port, mkd=False)(torch.from_numpy(images), torch.from_numpy(masks),
                                          torch.from_numpy(oh), 3)
    return jax.tree_util.tree_map(np.asarray, want), got


def port_grads_fp64(cid: str, b: int = 2, seed: int = 1) -> dict:
    """The gradients of ``train_case``'s port step computed in fp64 (every
    parameter, buffer and compute dtype, and the norms' and resizes' fp32
    casts, widened): the exact gradient's stand-in, against which both fp32
    steps are measured."""
    import copy
    from unittest import mock

    import mdvit_tpu_torch.ops.resize as resize

    _, variables, _ = case(cid)
    h, w = CASES[cid][3]
    rs = np.random.RandomState(seed)
    images, masks = stores(rs, h)
    data = (images, masks, rs.randint(0, 3, (D, b)).astype(np.int32))
    _, name, kw, _ = CASES[cid]
    port = build_model(name, num_domains=D, device="cpu", **kw)
    port.load_state_dict(from_jax_variables(variables, port))
    port = copy.deepcopy(port).double()
    for m in port.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    matrix = resize._matrix
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(torch.Tensor, "float", lambda t: t.to(torch.float64)), \
                mock.patch.object(resize, "_matrix", lambda *a: matrix(*a).double()):
            grads, _ = port_step(port, data, mkd=False)
    finally:
        torch.set_default_dtype(dtype)
    return grads


def rel_l2(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over all the gradients, in fp64."""
    num = sum(float(((g.double() - want[n].double()) ** 2).sum()) for n, g in got.items())
    return (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5
