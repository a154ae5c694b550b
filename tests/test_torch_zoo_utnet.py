"""The port's UTNet and its align-corners resize against the JAX package's,
on the CPU.

tests/test_comparators.py's tiny UTNet (base_chan 4, reduce_size 2, 2 heads;
tests/torch_zoo.py), the same seeded variables and inputs on both sides,
fp32, JAX at ``highest``: the eval forward within 1e-4·max(1, max|ref|), one
train step (attention and projection dropout 0) at tests/torch_family.py's
tolerances. ``resize_bilinear_align_corners`` (two matrix products, UTNet's
and TransFuse's upsamples) against JAX's, forward and backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.ops.resize import resize_bilinear_align_corners as jax_resize_ac
from mdvit_tpu_torch.ops.resize import resize_bilinear_align_corners
from torch_family import check_batch_stats, check_gradients, check_metrics
from torch_zoo import check_maps, eval_forwards, train_case

torch.set_num_threads(2)

# fp32, two taps an axis summed in another order than XLA's einsums
RESIZE_TOL = dict(rtol=1e-5, atol=1e-6)


def test_eval_forward_matches_jax():
    want, got, want_feat, got_feat = eval_forwards("UTNet")
    check_maps(want, got)
    check_maps([want_feat], [got_feat])


def test_train_step_metrics_match_jax():
    want, _, _, got = train_case("UTNet")
    check_metrics(want, got)


def test_train_step_gradients_match_jax():
    want, _, grads, _ = train_case("UTNet")
    check_gradients(want, grads)


def test_train_step_batch_stats_match_jax():
    want, model, _, _ = train_case("UTNet")
    check_batch_stats(want, model)


@pytest.mark.parametrize("src,dst", [((2, 2), (32, 32)), ((8, 6), (4, 4)), ((5, 7), (11, 9)),
                                     ((16, 16), (1, 3))])
def test_align_corners_resize_matches_jax(src, dst):
    """Forward, and the backward of a weighted sum, against JAX's."""
    rs = np.random.RandomState(src[0] * 100 + dst[1])
    x = rs.standard_normal((2, *src, 3)).astype(np.float32)
    g = rs.standard_normal((2, *dst, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want, vjp = jax.vjp(lambda t: jax_resize_ac(t, dst), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = resize_bilinear_align_corners(xt, dst)
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **RESIZE_TOL)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), **RESIZE_TOL)


def test_align_corners_resize_is_interpolate():
    """The matrices are ``F.interpolate(align_corners=True)``'s, and a
    matching size returns the input itself."""
    x = torch.randn(2, 5, 7, 3, generator=torch.Generator().manual_seed(0))
    got = resize_bilinear_align_corners(x, (11, 9))
    want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(11, 9),
                                           mode="bilinear", align_corners=True)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-6)
    assert resize_bilinear_align_corners(x, (5, 7)) is x


def test_utnet_default_widths():
    """The registry's UTNet: base_chan 32, reduce_size 8, 4 heads, one
    transformer block a stage, attention and projection dropout 0.1."""
    from mdvit_tpu_torch.models.registry import build_model

    model = build_model("UTNet", device="meta")
    assert model.outc.in_channels == 32 and model.down4_conv.conv2.out_channels == 512
    attn = model.down1_t0.attn
    assert attn.reduce_size == 8 and attn.heads == 4
    assert attn.attn_drop == attn.proj_drop == 0.1
    assert not hasattr(model, "down1_t1")
