"""The port's layers and norms against the JAX package's flax modules.

Each flax module is initialised, its parameters and BN stats perturbed from a
seeded numpy RandomState, and the variables carried into the port's module by
``from_jax_variables`` (placed at the path the module has inside MDViT).
fp32 on both sides, JAX at ``highest`` precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.models.decoders import MLPDecoderFM as JaxMLPDecoderFM
from mdvit_tpu.ops import layers as jl
from mdvit_tpu.ops.norm import DomainBatchNorm as JaxBN
from mdvit_tpu.ops.norm import DomainLayerNorm as JaxLN
from mdvit_tpu.ops.resize import resize_bilinear as jax_resize
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.decoders import MLPDecoderFM
from mdvit_tpu_torch.ops import layers as tl
from mdvit_tpu_torch.ops.norm import DomainBatchNorm, DomainLayerNorm
from mdvit_tpu_torch.ops.resize import resize_bilinear

torch.set_num_threads(2)

# fp32 sums in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-5)


def _init(module, *args, seed=0, **kw):
    """flax init, then every leaf perturbed (running var kept positive)."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    rs = np.random.RandomState(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        noise = rs.standard_normal(leaf.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return leaf * np.exp(0.2 * noise)
        return leaf + 0.05 * noise

    return jax.tree_util.tree_map_with_path(perturb, dict(variables))


def _carry(variables, flax_path, torch_prefix, stacked=False):
    """The port's state_dict of a module sitting at ``flax_path`` in MDViT."""
    tree = {}
    for col, sub in variables.items():
        if stacked:  # the debranch's leading domain axis
            sub = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], sub)
        for part in reversed(flax_path.split("/")):
            sub = {part: sub}
        tree[col] = sub
    sd = from_jax_variables(tree)
    assert all(k.startswith(torch_prefix) for k in sd), sorted(sd)
    return {k[len(torch_prefix):]: v for k, v in sd.items()}


def _port(module, variables, flax_path, torch_prefix, stacked=False):
    module.load_state_dict(_carry(variables, flax_path, torch_prefix, stacked))
    return module.eval()


def _randn(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _check(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_layer_norm():
    rs = np.random.RandomState(0)
    x = 3.0 + _randn(rs, 2, 16, 64)
    mod = JaxLN(num_features=64)
    v = _init(mod, x)
    port = _port(DomainLayerNorm(64), v, "core/mhsa_stage0/block0/norm1",
                 "mhsa_stages.0.mhca_blks.0.norm1.")
    _check(port(torch.from_numpy(x)), mod.apply(v, x))


def test_batch_norm_eval():
    rs = np.random.RandomState(1)
    x = _randn(rs, 2, 4, 4, 32)
    mod = JaxBN(num_features=32, num_domains=4)
    v = _init(mod, x, None, use_running_average=True)
    port = _port(DomainBatchNorm(32), v, "core/bridge_bn1", "bridge.1.")
    _check(port(torch.from_numpy(x)), mod.apply(v, x, None, use_running_average=True))
    # train mode: per-domain batch moments and the folded running stats
    oh = np.eye(4, dtype=np.float32)[[3, 1]]
    want, upd = mod.apply(v, x, oh, use_running_average=False, mutable=["batch_stats"])
    _check(port(torch.from_numpy(x), torch.from_numpy(oh), train=True), want)
    _check(port.running_mean, upd["batch_stats"]["mean"])
    _check(port.running_var, upd["batch_stats"]["var"])


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((16, 12), (6, 5)),
                                     ((8, 8), (8, 8))])
def test_resize_bilinear(src, dst):
    rs = np.random.RandomState(2)
    x = _randn(rs, 2, *src, 3)
    _check(resize_bilinear(torch.from_numpy(x), dst), jax_resize(jnp.asarray(x), dst))


def test_conv_bn():
    rs = np.random.RandomState(3)
    x = _randn(rs, 2, 16, 16, 3)
    mod = jl.ConvBN(features=32, kernel_size=3, stride=2, padding=1, act="hardswish")
    v = _init(mod, x)
    port = _port(tl.ConvBN(3, 32, 3, 2, 1), v, "core/stem1",
                 "stem.0.")
    _check(port(torch.from_numpy(x)), mod.apply(v, x))


@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv_bn_patch_embed_wiring(stride):
    rs = np.random.RandomState(4)
    x = _randn(rs, 2, 8, 8, 64)
    mod = jl.DWConvBN(features=128, kernel_size=3, stride=stride,
                      act="hardswish", dw_groups_on="in")
    v = _init(mod, x)
    port = _port(tl.DWConvBN(64, 128, 3, stride, "in"), v,
                 "core/patch_embed1", "patch_embed_stages.1.patch_conv.")
    _check(port(torch.from_numpy(x)), mod.apply(v, x))


def test_dwconv_bn_decoder_wiring():
    """2C→C grouped conv: the JAX even/odd (k, k, 2, C) kernel equals the
    torch weight (C, 2, k, k)."""
    rs = np.random.RandomState(5)
    x = _randn(rs, 2, 8, 8, 128)
    mod = jl.DWConvBN(features=64, kernel_size=3, dw_groups_on="out")
    v = _init(mod, x)
    port = _port(tl.DWConvBN(128, 64, 3, 1, "out"), v,
                 "core/decoder4/conv_after", "decoder4.conv_after.")
    _check(port(torch.from_numpy(x)), mod.apply(v, x))


def test_mlp_gelu():
    rs = np.random.RandomState(6)
    x = _randn(rs, 2, 16, 64)
    mod = jl.Mlp(hidden_features=256)
    v = _init(mod, x)
    port = _port(tl.Mlp(64, 256), v, "core/mhsa_stage0/block0/mlp",
                 "mhsa_stages.0.mhca_blks.0.mlp.")
    _check(port(torch.from_numpy(x)), mod.apply(v, x))


def test_fast_gelu_constants():
    x = np.linspace(-9, 9, 721, dtype=np.float32)
    _check(tl.fast_gelu(torch.from_numpy(x)), jl.fast_gelu(jnp.asarray(x)))


def test_mlp_decoder_fm_eval():
    rs = np.random.RandomState(7)
    dims = (64, 128, 320, 512)
    feats = [_randn(rs, 2, 8 >> i, 8 >> i, c) for i, c in enumerate(dims)]
    feats.append(_randn(rs, 2, 8, 8, 64))
    mod = JaxMLPDecoderFM(hidden_channel=512, out_channel=1, img_size=(32, 32))
    v = _init(mod, feats)
    port = _port(MLPDecoderFM(dims, 64, (32, 32)), v, "debranch",
                 "debranch1.", stacked=True)
    got = port([torch.from_numpy(f) for f in feats]).detach().numpy()
    want = np.asarray(mod.apply(v, feats))
    # the fuse conv sums 4·512 + 64 products into outputs of scale ~1e2:
    # held to 1e-5 of the output scale rather than elementwise
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
