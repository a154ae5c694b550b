"""The port's SwinUnet, SwinUNETR and Swin classifier against the JAX
package's, on the CPU, and the registry's completeness.

tests/test_comparators.py's tiny configurations (tests/torch_zoo.py): the
same seeded variables through ``from_jax_variables`` (held to the model) and
the same inputs on both sides, fp32, JAX at ``highest``. The eval forward's
maps within 1e-4·max(1, max|ref|); one train step (stochastic depth 0) at
tests/torch_family.py's tolerances. The pieces: the shifted-window mask, the
transposed conv's weight mapping, ``swin_tiny``'s parameter count.
"""
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.models import registry as jax_registry
from mdvit_tpu.models.swin_unet import SwinClassifier as JaxSwinClassifier
from mdvit_tpu.models.swin_unet import _shift_attn_mask as jax_shift_attn_mask
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models import registry
from mdvit_tpu_torch.models.swin_unet import _shift_attn_mask
from mdvit_tpu_torch.models.swin_unetr import ConvTranspose2x2
from torch_family import check_batch_stats, check_gradients, check_metrics, random_variables
from torch_zoo import check_maps, eval_forwards, train_case

torch.set_num_threads(2)

MODELS = ["SwinUnet", "SwinUNETR"]
CLASSIFIERS = ("mpvit_tiny", "mpvit_xsmall", "mpvit_small", "mpvit_base", "coat_tiny",
               "coat_mini", "coat_small", "coat_lite_tiny", "coat_lite_mini",
               "coat_lite_small")


@pytest.mark.parametrize("cid", MODELS)
def test_eval_forward_matches_jax(cid):
    want, got, want_feat, got_feat = eval_forwards(cid)
    check_maps(want, got)
    check_maps([want_feat], [got_feat])


@pytest.mark.parametrize("cid", MODELS)
def test_train_step_metrics_match_jax(cid):
    want, _, _, got = train_case(cid)
    check_metrics(want, got)


@pytest.mark.parametrize("cid", MODELS)
def test_train_step_gradients_match_jax(cid):
    want, model, grads, _ = train_case(cid)
    check_gradients(want, grads)
    check_batch_stats(want, model)  # none: LayerNorms and InstanceNorms only


@pytest.mark.parametrize("h,w,window,shift", [(8, 8, 4, 2), (16, 16, 8, 4), (16, 8, 4, 2)])
def test_shift_mask_matches_jax(h, w, window, shift):
    np.testing.assert_array_equal(_shift_attn_mask(h, w, window, shift),
                                  jax_shift_attn_mask(h, w, window, shift))


def test_conv_transpose_mapping():
    """flax's ``ConvTranspose`` (kernel 2, stride 2, unturned kernel) equals
    the port's ``ConvTranspose2d`` with the converted weight: (kh, kw, in,
    out) → (in, out, kh, kw), both spatial axes flipped."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 3, 6)).astype(np.float32)
    kernel = rs.standard_normal((2, 2, 6, 4)).astype(np.float32)
    ref = flax_nn.ConvTranspose(4, (2, 2), (2, 2), use_bias=False).apply(
        {"params": {"kernel": kernel}}, x)
    state = from_jax_variables({"params": {"transformer": {"transp_conv": {"kernel": kernel}}}})
    conv = ConvTranspose2x2(6, 4)
    conv.weight.data.copy_(state["transformer.transp_conv.weight"])
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10, 6, 4)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    # without the flip the map is wrong
    assert not np.allclose(np.transpose(kernel, (2, 3, 0, 1)),
                           state["transformer.transp_conv.weight"].numpy())


def test_swin_tiny_parameter_count_equals_jax():
    shapes = jax.eval_shape(lambda k: jax_registry.get_model("swin_tiny").init(
        {"params": k}, jnp.zeros((1, 224, 224, 3))), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = registry.build_model("swin_tiny", device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert model.config["img_size"] == 224


def test_swin_classifier_forward_matches_jax():
    kw = dict(img_size=32, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
              window=4, num_classes=5, ape=True)
    jm = JaxSwinClassifier(**kw)
    x = np.random.RandomState(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    # the classifier's second positional argument is ``train``
    variables = random_variables(jm, jnp.asarray(x), False, call_kw={})
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    port = registry.build_model("swin_tiny", device="cpu", **kw)
    port.load_state_dict(from_jax_variables(variables, port))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    check_maps([np.asarray(ref["logits"]), np.asarray(ref["feat"])],
               [out["logits"].numpy(), out["feat"].numpy()])


def test_registry_covers_jax():
    """Every model the JAX registry builds is ported, the MPViT and CoaT
    classifiers among them, and ``coat_tiny`` builds: a classifier's
    output at its 224² default."""
    assert set(jax_registry.list_models()) <= set(registry.BUILDERS)
    assert set(CLASSIFIERS) < set(registry.CLASSIFIERS)
    model = registry.build_model("coat_tiny", device="cpu", num_classes=5)
    assert model.config["img_size"] == 224
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 3))
    assert out["logits"].shape == (1, 5) and out["feat"].shape == (1, 152)


def test_swin_unet_default_widths():
    """The registry's SwinUnet: window 8, embed 96, depths (2, 2, 6, 2),
    stochastic depth 0.1, as ``build_swin_unet`` builds it."""
    model = registry.build_model("SwinUnet", device="meta")
    assert model.layer0_block1.attn.window == 8 and model.layer0_block1.shift == 4
    assert model.patch_embed.out_channels == 96 and model.depths == (2, 2, 6, 2)
    assert model.dpr[-1] == pytest.approx(0.1)
    assert model.up0.expand.in_features == 768


@pytest.mark.parametrize("name,kw", [
    ("SwinUnet", dict(img_size=32, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                      window=4)),
    ("SwinUNETR", dict(img_size=32, feature_size=4, depths=(1, 1, 1, 1),
                       num_heads=(1, 2, 4, 8), window=4)),
    ("UTNet", dict(base_chan=4, reduce_size=2, num_heads=(2, 2, 2, 2))),
    ("TransFuse_S_adapt", dict(img_size=(32, 64))),
    ("swin_tiny", dict(img_size=32, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                       window=4, num_classes=3)),
])
def test_weights_file_rebuilds_the_model(tmp_path, name, kw):
    """``save_weights`` records a comparator's name and arguments, and
    ``load_weights`` rebuilds it: same class, same tensors, same forward."""
    model = registry.build_model(name, device="cpu", seed=5, **kw)
    path = str(tmp_path / "w.pt")
    registry.save_weights(path, model)
    back = registry.load_weights(path, device="cpu")
    assert type(back) is type(model) and back.config == model.config
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in model.state_dict().items())
    h, w = (kw.get("img_size", 32),) * 2 if isinstance(kw.get("img_size", 32), int) \
        else kw["img_size"]
    x = torch.randn(1, h, w, 3, generator=torch.Generator().manual_seed(0))
    args = (x,) if name == "swin_tiny" else (x, torch.eye(4)[:1])
    with torch.no_grad():
        a, b = model(*args), back(*args)
    key = "logits" if name == "swin_tiny" else "feat"
    assert torch.equal(a[key], b[key])
