"""The port's on-device augmentation (``mdvit_tpu_torch/data/augment.py``)
against the JAX package's (``mdvit_tpu/data/augment.py``), on the CPU.

JAX's per-sample draws come from threefry, which the port cannot match, so
the whole-pipeline test recomputes them from the JAX key with the same
``jax.random`` calls as ``augment_batch`` and hands them to the port's
``augment_with_params``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.data import augment as ja
from mdvit_tpu_torch.data import augment as ta
from mdvit_tpu_torch.data.datasets import synthetic_domain_arrays
from mdvit_tpu_torch.ops.layers import fast_normal, fast_uniform

torch.set_num_threads(2)

MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# the warp cases: identity, the corners of the recipe's ranges, and between
WARP_CASES = [(0.0, 1.0, (0.0, 0.0)), (45.0, 1.1, (0.0625, -0.0625)),
              (-45.0, 0.9, (-0.0625, 0.0625)), (45.0, 0.9, (0.0625, 0.0625)),
              (-45.0, 1.1, (-0.0625, -0.0625)), (30.0, 1.05, (0.05, -0.03))]
# images on the 0..255 scale: the two samplers blend the same four taps with
# fp32 products in another order (measured 3e-5 here)
WARP_IMG_TOL = 1e-3


@pytest.mark.parametrize("offset", [0, 1, 5])
@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_fast_uniform_bit_equal(seed, offset):
    want = np.asarray(ja.fast_uniform(jnp.uint32(seed), (3, 5, 7), offset=offset))
    np.testing.assert_array_equal(fast_uniform(seed, (3, 5, 7), offset=offset).numpy(), want)
    # the augmentation's seed is a device tensor
    got = fast_uniform(torch.tensor(seed, dtype=torch.int64), (3, 5, 7), offset=offset)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fast_normal_matches_jax():
    """log and cos round as each libm does: 1e-5 abs on N(0, 1) values."""
    want = np.asarray(ja.fast_normal(jnp.uint32(123), (4, 16, 16, 3)))
    got = fast_normal(torch.tensor(123), (4, 16, 16, 3)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reflect101_against_literal():
    got = ta.reflect101(torch.arange(-3, 8), 5)
    np.testing.assert_array_equal(got.numpy(), [3, 2, 1, 0, 1, 2, 3, 4, 3, 2, 1])
    assert not ta.reflect101(torch.arange(-2, 3), 1).any()


def _warp_inputs(size: int, rs):
    b = len(WARP_CASES)
    imgs = np.floor(rs.rand(b, size, size, 3) * 256).clip(0, 255).astype(np.float32)
    msks = (rs.rand(b, size, size) > 0.5).astype(np.float32)
    angle = np.asarray([c[0] for c in WARP_CASES], np.float32)
    scale = np.asarray([c[1] for c in WARP_CASES], np.float32)
    shift = np.asarray([c[2] for c in WARP_CASES], np.float32)
    return imgs, msks, angle, scale, shift


@pytest.mark.parametrize("size", [16, 64])
def test_warp_matches_jax_at_every_pixel(size):
    """The port's sampler against the JAX package's production block warp
    (``_ssr_apply_block``) and its exact sampler (``_affine_sample``, the
    core of ``_ssr_single``), on the same inverse maps, at every pixel:
    masks exact, images within WARP_IMG_TOL."""
    imgs, msks, angle, scale, shift = _warp_inputs(size, np.random.RandomState(size))
    a_inv, t_inv = jax.jit(jax.vmap(
        lambda an, sc, dx, dy: ja._rotation_matrix(an, sc, dx, dy, size, size)))(
            angle, scale, shift[:, 0], shift[:, 1])
    block_i, block_m = jax.jit(ja._ssr_apply_block)(imgs, msks, angle, scale, shift)
    ref_i, ref_m = jax.jit(jax.vmap(lambda i, m, a, t: (
        ja._affine_sample(i, a, t, nearest=False),
        ja._affine_sample(m[..., None], a, t, nearest=True)[..., 0])))(imgs, msks, a_inv, t_inv)
    got_i, got_m = ta.warp_affine(torch.from_numpy(imgs), torch.from_numpy(msks),
                                  torch.from_numpy(np.array(a_inv)),
                                  torch.from_numpy(np.array(t_inv)))
    for want_i, want_m in ((ref_i, ref_m), (block_i, block_m)):
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                                   atol=WARP_IMG_TOL)
    # the borders are in the comparison: many pixels sample reflected taps
    xs = np.arange(size, dtype=np.float64)
    a, t = np.asarray(a_inv, np.float64), np.asarray(t_inv, np.float64)
    sx = a[:, 0, 0, None, None] * xs[None, None] + a[:, 0, 1, None, None] * xs[None, :, None] \
        + t[:, 0, None, None]
    assert ((sx < 0) | (sx > size - 1)).sum() > 2 * size


@pytest.mark.parametrize("size", [16, 64])
def test_warp_identity_is_exact(size):
    imgs, msks, *_ = _warp_inputs(size, np.random.RandomState(1))
    b = imgs.shape[0]
    got_i, got_m = ta.warp(torch.from_numpy(imgs), torch.from_numpy(msks), torch.zeros(b),
                           torch.ones(b), torch.zeros(b, 2))
    np.testing.assert_array_equal(got_i.numpy(), imgs)
    np.testing.assert_array_equal(got_m.numpy(), msks)


def test_rotation_matrix_matches_jax():
    """The port takes cos and sin in fp64 (so the CPU and the card agree);
    XLA's fp32 libm rounds them up to an ulp or two away."""
    rs = np.random.RandomState(2)
    n = 256
    angle = rs.uniform(-45, 45, n).astype(np.float32)
    scale = (1 + rs.uniform(-0.1, 0.1, n)).astype(np.float32)
    dx, dy = (rs.uniform(-0.0625, 0.0625, (2, n)).astype(np.float32))
    want_a, want_t = jax.jit(jax.vmap(
        lambda an, sc, x, y: ja._rotation_matrix(an, sc, x, y, 64, 48)))(angle, scale, dx, dy)
    got_a, got_t = ta.rotation_matrix(*map(torch.from_numpy, (angle, scale, dx, dy)), 64, 48)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=5e-7)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-5)


def _jax_params(key, b: int) -> dict:
    """augment_batch's draws for ``key`` (mdvit_tpu/data/augment.py:436-469)."""
    k_noise, k_napply, k_h, k_v, k_ssr, k_bc = jax.random.split(key, 6)
    var = jax.random.uniform(jax.random.fold_in(k_noise, 1), (b, 1, 1, 1),
                             minval=10.0, maxval=50.0)
    seed = ja._seed_from_key(k_noise)
    apply_n = jax.random.bernoulli(k_napply, 0.5, (b, 1, 1, 1))
    fh = jax.random.bernoulli(k_h, 0.5, (b, 1, 1, 1))
    fv = jax.random.bernoulli(k_v, 0.5, (b, 1, 1, 1))
    k1, k2, k3, k4 = jax.random.split(k_ssr, 4)
    apply = jax.random.bernoulli(k1, 0.5, (b,))
    angle = jnp.where(apply, jax.random.uniform(k2, (b,), minval=-45.0, maxval=45.0), 0.0)
    scale = jnp.where(apply, 1.0 + jax.random.uniform(k3, (b,), minval=-0.1, maxval=0.1),
                      1.0)
    shift = jnp.where(apply[:, None], jax.random.uniform(
        k4, (b, 2), minval=-0.0625, maxval=0.0625), jnp.zeros((b, 2)))
    kb1, kb2, kb3 = jax.random.split(k_bc, 3)
    apply_bc = jax.random.bernoulli(kb1, 0.5, (b, 1, 1, 1))
    alpha = 1.0 + jax.random.uniform(kb2, (b, 1, 1, 1), minval=-0.2, maxval=0.2)
    beta = jax.random.uniform(kb3, (b, 1, 1, 1), minval=-0.2, maxval=0.2)

    def t(a):  # one value per sample
        return torch.from_numpy(np.array(a).reshape(b))

    return {"noise_apply": t(apply_n), "noise_var": t(var),
            "noise_seed": torch.tensor(int(seed), dtype=torch.int64),
            "flip_h": t(fh), "flip_v": t(fv), "angle": t(angle), "scale": t(scale),
            "shift": torch.from_numpy(np.array(shift)), "bc_apply": t(apply_bc),
            "alpha": t(alpha), "beta": t(beta)}


# Whole pipeline, images on the 0..255 scale, as the JAX output's normalize
# inverted (rounding ~1e-4): the port's inverse map may sit an ulp from
# XLA's (its fp32 cos, test_rotation_matrix_matches_jax), which moves a
# bilinear sample by ~1e-5 px times the image's local slope, so values agree
# within AUG_IMG_TOL (8e-4 at most measured here). fast_normal's last bits can move the noise's floor by
# one level: at most AUG_FLOOR_SHARE of the values may then differ by up to
# AUG_FLOOR_STEP (a level through the warp's blend and the contrast α ≤ 1.2).
AUG_IMG_TOL = 2e-3
AUG_FLOOR_SHARE = 1e-3
AUG_FLOOR_STEP = 1.25


def test_augment_matches_jax_augment_batch():
    b, size = 8, 32
    data = synthetic_domain_arrays("PH2", size, b, 0)["train"]
    imgs = data.images.astype(np.float32)
    msks = data.masks.astype(np.float32)
    run = jax.jit(ja.augment_batch)
    seen = {k: set() for k in ("noise_apply", "flip_h", "flip_v", "bc_apply")}
    n_floor = n_vals = 0
    for k in range(4):
        key = jax.random.PRNGKey(k)
        want_x, want_y = map(np.asarray, run(key, imgs, msks))
        params = _jax_params(key, b)
        got_x, got_y = ta.augment_with_params(torch.from_numpy(imgs), torch.from_numpy(msks),
                                              params)
        np.testing.assert_array_equal(got_y.numpy(), want_y)
        want255 = (want_x * STD + MEAN) * 255.0
        got255 = (got_x.numpy() * STD + MEAN) * 255.0
        err = np.abs(got255 - want255)
        n_floor += int((err > AUG_IMG_TOL).sum())
        n_vals += err.size
        assert err.max() <= AUG_FLOOR_STEP, err.max()
        for name in seen:
            seen[name] |= set(params[name].tolist())
    assert n_floor <= AUG_FLOOR_SHARE * n_vals, n_floor
    assert all(s == {True, False} for s in seen.values()), seen


def test_sample_aug_params_ranges_and_identity():
    gen = torch.Generator().manual_seed(3)
    p = ta.sample_aug_params(gen, 4096, "cpu")
    assert p["noise_seed"].dtype == torch.int64 and 0 <= int(p["noise_seed"]) < 2 ** 32
    assert ((p["noise_var"] >= 10) & (p["noise_var"] < 50)).all()
    assert ((p["alpha"] >= 0.8) & (p["alpha"] <= 1.2)).all()
    assert (p["beta"].abs() <= 0.2).all()
    on = p["angle"] != 0
    assert (p["angle"].abs() <= 45).all() and ((p["scale"] - 1).abs() <= 0.1).all()
    assert (p["shift"].abs() <= 0.0625).all()
    assert not p["shift"][~on].any() and (p["scale"][~on] == 1).all()
    for name in ("noise_apply", "flip_h", "flip_v", "bc_apply"):
        assert 0.45 < p[name].float().mean() < 0.55, name
    again = ta.sample_aug_params(torch.Generator().manual_seed(3), 4096, "cpu")
    for k, v in p.items():
        assert torch.equal(v, again[k]), k


def test_augment_batch_labels_follow_the_warp():
    """augment_batch end to end on the CPU: normalised finite images and
    {0, 1} labels, and a mask that moves with its image: the labels equal
    augment_with_params' for the same draws."""
    data = synthetic_domain_arrays("DMF", 32, 4, 0)["train"]
    imgs = torch.from_numpy(data.images).float()
    msks = torch.from_numpy(data.masks).float()
    x, y = ta.augment_batch(torch.Generator().manual_seed(0), imgs, msks)
    params = ta.sample_aug_params(torch.Generator().manual_seed(0), 4, "cpu")
    x2, y2 = ta.augment_with_params(imgs, msks, params)
    assert x.shape == (4, 32, 32, 3) and y.shape == (4, 32, 32, 1)
    assert torch.isfinite(x).all() and set(y.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(x, x2) and torch.equal(y, y2)
