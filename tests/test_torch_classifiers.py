"""The port's MPViT, CoaT-Lite and CoaT classifiers against the JAX
package's, on the CPU.

Small widths at img 32 (scales 8², 4², 2², 1²), 8 heads (the CRPE window
split is 2 + 3 + 3 heads), head widths off MDViT's {8, 16, 40, 64}: MPViT
with 2 paths and 1 block a stage, CoaT-Lite with serial blocks only, CoaT
with one parallel block. The same seeded flax variables
(tests/torch_family.py's draws) go to the port through
``convert.from_jax_variables``, held to the model; the same numpy inputs go
to both sides, fp32, JAX at ``highest``. Eval logits and feat within
1e-4·max(1, max|ref|) (tests/torch_zoo.py's tolerance); the gradients of a
cross-entropy of the eval forward against ``jax.grad``, each leaf relative to
its largest value (``check_gradients``). The ten registry names at their
published widths on the meta device: parameter counts equal to the JAX
modules' ``eval_shape`` counts. The kernel launches of one forward and one
backward pull, counted on the ops' CPU kernels, as ``chip_smoke.py``'s
classifiers phase asserts them on the card. ``_interp_tokens``'
downsampling resizes (28→14, 28→7, 14→7) against ``jax.image.resize``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdvit_tpu.models import registry as jax_registry
from mdvit_tpu.models.coat import CoaT as JaxCoaT
from mdvit_tpu.models.coat import _interp_tokens as jax_interp_tokens
from mdvit_tpu.models.mpvit import MPViT as JaxMPViT
from mdvit_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models import registry
from mdvit_tpu_torch.models.coat import CoaT, _interp_tokens
from mdvit_tpu_torch.models.mpvit import MPViT
from mdvit_tpu_torch.ops import dwconv
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.resize import resize_bilinear
from torch_family import check_gradients, random_variables
from torch_zoo import check_maps

torch.set_num_threads(2)

IMG = 32
CLASSES = 7
# head widths 2, 3, 5, 7 (MPViT, CoaT-Lite) and 2, 3 (CoaT): C = 8·ch
MPVIT = dict(num_classes=CLASSES, num_path=(2, 2, 2, 2), num_layers=(1, 1, 1, 1),
             embed_dims=(16, 24, 40, 56), mlp_ratios=(2, 2, 1, 1))
COAT_LITE = dict(num_classes=CLASSES, embed_dims=(16, 24, 40, 56),
                 serial_depths=(1, 1, 1, 1), parallel_depth=0, mlp_ratios=(2, 2, 1, 1))
COAT = dict(num_classes=CLASSES, embed_dims=(16, 24, 24, 24), serial_depths=(1, 1, 1, 1),
            parallel_depth=1, mlp_ratios=(2, 2, 2, 2))
# case id → (flax module, port module, keywords)
CASES = {"mpvit": (JaxMPViT, MPViT, MPVIT), "coat_lite": (JaxCoaT, CoaT, COAT_LITE),
         "coat": (JaxCoaT, CoaT, COAT)}
NAMES = ("mpvit_tiny", "mpvit_xsmall", "mpvit_small", "mpvit_base", "coat_tiny",
         "coat_mini", "coat_small", "coat_lite_tiny", "coat_lite_mini", "coat_lite_small")


@functools.lru_cache(maxsize=None)
def case(cid: str):
    """(flax module, its seeded variables, the port model loaded with them)."""
    jax_cls, port_cls, kw = CASES[cid]
    model = jax_cls(**kw)
    variables = random_variables(model, jnp.zeros((2, IMG, IMG, 3)), None,
                                 call_kw={"train": False})
    port = port_cls(**kw).eval()
    port.load_state_dict(from_jax_variables(variables, port))
    return model, variables, port


def _inputs(seed: int = 1):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    labels = rs.randint(0, CLASSES, 3)
    return x, labels


@pytest.mark.parametrize("cid", CASES)
def test_eval_forward_matches_jax(cid):
    model, variables, port = case(cid)
    x, _ = _inputs()
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got["logits"].shape == (3, CLASSES)
    check_maps([np.asarray(want["logits"]), np.asarray(want["feat"])],
               [got["logits"].numpy(), got["feat"].numpy()])


@pytest.mark.parametrize("cid", CASES)
def test_gradients_match_jax(cid):
    """The mean cross-entropy of the eval forward's logits, differentiated
    by ``jax.grad`` and by the port's autograd (through the ops' backward
    kernels' plain versions): every parameter's gradient."""
    model, variables, port = case(cid)
    x, labels = _inputs(2)

    def loss(params):
        logits = model.apply({**variables, "params": params}, x, train=False)["logits"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    want = {"grads": from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, grads)})}
    port.zero_grad()
    F.cross_entropy(port(torch.from_numpy(x))["logits"], torch.from_numpy(labels)).backward()
    got = {n: p.grad for n, p in port.named_parameters()}
    port.zero_grad()
    check_gradients(want, got)


def test_weights_file_and_conversion_hold_to_the_model(tmp_path):
    """``save_weights``/``load_weights`` carry a classifier's registry name
    and widths; a flax tree that lacks a leaf of the model, or holds one
    the model lacks, does not convert against it."""
    _, variables, _ = case("coat")
    model = registry.build_model("coat_tiny", device="cpu", **COAT)
    model.load_state_dict(from_jax_variables(variables, model))
    path = str(tmp_path / "coat.pt")
    registry.save_weights(path, model)
    back = registry.load_weights(path, device="cpu")
    assert type(back) is CoaT and back.config["name"] == "coat_tiny"
    x = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        assert torch.equal(back(x)["logits"], model(x)["logits"])
    params = dict(variables["params"])
    params.pop("agg_bias")
    with pytest.raises(ValueError, match="unset: agg_bias"):
        from_jax_variables({**variables, "params": params}, model)
    lite = registry.build_model("coat_lite_tiny", device="cpu", **dict(COAT, parallel_depth=0))
    with pytest.raises(ValueError, match="no such tensor: parallel_0"):
        from_jax_variables(variables, lite)


def _counted():
    """Counts of the six ops' CPU kernels (what a card launches), by name."""
    counts = dict.fromkeys(("factorized_attention", "cpe_conv", "crpe_conv",
                            "factorized_attention_bwd", "cpe_conv_bwd", "crpe_conv_bwd"), 0)
    ops = {"factorized_attention": fa._attention_op, "factorized_attention_bwd":
           fa._attention_bwd_op, "cpe_conv": dwconv._cpe_op, "cpe_conv_bwd": dwconv._cpe_bwd_op,
           "crpe_conv": dwconv._crpe_op, "crpe_conv_bwd": dwconv._crpe_bwd_op}
    saved = {name: op._backend_fns["cpu"] for name, op in ops.items()}

    def wrap(name, fn):
        def run(*a):
            counts[name] += 1
            return fn(*a)
        return run

    for name, op in ops.items():
        op._backend_fns["cpu"] = wrap(name, saved[name])
    return counts, lambda: [op._backend_fns.__setitem__("cpu", saved[n])
                            for n, op in ops.items()]


@pytest.mark.parametrize("cid", CASES)
def test_one_forward_and_backward_launch_each_kernel_a_block(cid):
    """A, B and C once a block a forward, and A′, B′ and C′ once a block a
    backward pull: MPViT Σ num_path·num_layers blocks, CoaT Σ serial_depths
    + 3·parallel_depth (a parallel block attends at scales 2 to 4, each
    with its own CPE and CRPE)."""
    _, _, port = case(cid)
    kw = CASES[cid][2]
    if cid == "mpvit":
        blocks = sum(p * n for p, n in zip(kw["num_path"], kw["num_layers"]))
    else:
        blocks = sum(kw["serial_depths"]) + 3 * kw["parallel_depth"]
    x, labels = _inputs()
    counts, restore = _counted()
    try:
        logits = port(torch.from_numpy(x))["logits"]
        fwd = dict(counts)
        F.cross_entropy(logits, torch.from_numpy(labels)).backward()
    finally:
        restore()
        port.zero_grad()
    assert fwd == {"factorized_attention": blocks, "cpe_conv": blocks, "crpe_conv": blocks,
                   "factorized_attention_bwd": 0, "cpe_conv_bwd": 0, "crpe_conv_bwd": 0}
    assert counts == dict.fromkeys(counts, blocks)


def _jax_params(name: str) -> int:
    """The JAX builder's parameter count (``tests/test_classifiers.py``'s
    ``eval_shape`` of its init: nothing computes)."""
    model = jax_registry.get_model(name)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)), train=False))
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", NAMES)
def test_published_widths_param_count_matches_jax(name):
    model = registry.build_model(name, device="meta")
    assert model.config["img_size"] == 224
    assert sum(p.numel() for p in model.parameters()) == _jax_params(name)


@pytest.mark.parametrize("src,dst", [((28, 28), (14, 14)), ((28, 28), (7, 7)),
                                     ((14, 14), (7, 7)), ((7, 7), (28, 28))])
def test_interp_tokens_resizes_as_jax(src, dst):
    """The decoders only upsample with ``resize_bilinear``; CoaT's parallel
    blocks also downsample (28→14, 28→7, 14→7 at 224²): half-pixel taps, no
    antialiasing, as ``jax.image.resize(antialias=False)``; the cls row
    passes through ``_interp_tokens``."""
    rs = np.random.RandomState(src[0] + dst[0])
    grid = rs.standard_normal((2, *src, 5)).astype(np.float32)
    np.testing.assert_allclose(resize_bilinear(torch.from_numpy(grid), dst).numpy(),
                               np.asarray(jax_resize_bilinear(jnp.asarray(grid), dst)),
                               rtol=0, atol=1e-6)
    tokens = rs.standard_normal((2, src[0] * src[1] + 1, 5)).astype(np.float32)
    got = _interp_tokens(torch.from_numpy(tokens), src, dst).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_interp_tokens(jnp.asarray(tokens), src, dst)),
                               rtol=0, atol=1e-6)
    assert np.array_equal(got[:, 0], tokens[:, 0])
