"""Determinism of the port's entry points (``device.deterministic``) and the
separable bilinear resize (``ops/resize.py``), whose backward replaced
``F.interpolate``'s atomics, against the JAX package's resize, on the CPU.
The same checks on a card are in ``test_torch_kernels_gpu.py``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdvit_tpu.ops.resize import resize_bilinear as jax_resize
from mdvit_tpu_torch.device import deterministic
from mdvit_tpu_torch.ops.resize import resize_bilinear, resize_matrix

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32, two taps an axis summed in another order than XLA's resize
RESIZE_TOL = dict(rtol=1e-5, atol=1e-6)


def _flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.utils.deterministic.fill_uninitialized_memory)


def test_deterministic_sets_and_restores_the_flags():
    saved = _flags()
    try:
        for before in ((False, False, False, True, True), (True, True, True, False, False)):
            torch.use_deterministic_algorithms(before[0], warn_only=before[1])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:4]
            torch.utils.deterministic.fill_uninitialized_memory = before[4]
            with deterministic():
                assert _flags() == (True, False, True, False, False)
            assert _flags() == before
        with pytest.raises(KeyError), deterministic():
            raise KeyError("an error inside")
        assert _flags() == before
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:4]
        torch.utils.deterministic.fill_uninitialized_memory = saved[4]


@pytest.mark.parametrize("preset", [None, ":16:8"])
def test_import_sets_the_cublas_workspace(preset):
    """Importing the port sets ``CUBLAS_WORKSPACE_CONFIG`` (cuBLAS reads it
    at its first handle) unless the caller set it."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    if preset is not None:
        env["CUBLAS_WORKSPACE_CONFIG"] = preset
    out = subprocess.run(
        [sys.executable, "-c", "import os, mdvit_tpu_torch; "
         "print(os.environ['CUBLAS_WORKSPACE_CONFIG'])"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == (preset or ":4096:8")


@pytest.mark.parametrize("src,dst,c", [((8, 8), (64, 64), 64), ((16, 16), (64, 64), 64),
                                       ((32, 32), (64, 64), 64), ((64, 64), (256, 256), 1),
                                       ((16, 12), (6, 5), 3)])
def test_resize_matches_jax_forward_and_vjp(src, dst, c):
    """The shapes the models resize at (the MLPFM debranch's scales to H/4
    with 64 channels, the logits ×4) and a downsample; forward and the VJP
    of a random cotangent."""
    rs = np.random.RandomState(sum(src) + c)
    x = rs.standard_normal((2, *src, c)).astype(np.float32)
    g = rs.standard_normal((2, *dst, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_resize(a, dst), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = resize_bilinear(xt, dst)
    (grad,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **RESIZE_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **RESIZE_TOL)


@pytest.mark.parametrize("size", [(4, 16), (64, 256), (13, 6), (5, 5)])
def test_resize_matrix_equals_interpolates_weights(size):
    """Each row of the matrix is F.interpolate's response to the unit
    vectors: the same taps and weights, rows summing to 1."""
    n_in, n_out = size
    eye = torch.eye(n_in).reshape(n_in, 1, 1, n_in)
    rows = F.interpolate(eye, size=(1, n_out), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(resize_matrix(n_in, n_out), rows[:, 0, 0].t().numpy(),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(resize_matrix(n_in, n_out).sum(1), 1.0, rtol=1e-6)


def test_train_step_repeats_its_bits():
    """Two MKD steps (dropout and augmentation on) from one state give the
    same losses, gradients, parameters and BN stats, bit for bit."""
    from mdvit_tpu_torch.models.registry import build_mdvit
    from mdvit_tpu_torch.train.optim import build_optimizer
    from mdvit_tpu_torch.train.steps import make_train_step

    rs = np.random.RandomState(5)
    imgs = [torch.from_numpy(rs.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8))
            for _ in range(4)]
    masks = [torch.from_numpy(rs.randint(0, 2, (3, 32, 32)).astype(np.uint8))
             for _ in range(4)]
    runs = []
    for _ in range(2):
        model = build_mdvit(img_size=32, device="cpu", seed=1, embed_dims=(16, 32, 40, 64),
                            num_layers=(1, 1, 1, 1))
        opt, sched = build_optimizer(model, steps_per_epoch=2)
        metrics = make_train_step(model, opt, sched, 4)(imgs, masks,
                                                        torch.tensor([[0, 2]] * 4))
        runs.append((metrics, [p.grad for p in model.parameters()], model.state_dict()))
    (m1, g1, s1), (m2, g2, s2) = runs
    assert all(torch.equal(v, m2[k]) for k, v in m1.items())
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(torch.equal(v, s2[k]) for k, v in s1.items())
