"""The port's training pieces below the model, against the JAX package.

* The chunked two-launch algorithm of the factorized-attention backward
  kernel (partials per token chunk, a fixed-order fold, the apply pass),
  written out in plain torch, against ``jax.vjp`` of the XLA twin at ragged N
  (the forward's, on the same helpers, is in ``test_torch_kernels_ref.py``).
* The plain backwards beside the CUDA kernels (``factorized_attention_bwd_ref``,
  ``cpe_conv_bwd_ref``, ``crpe_conv_bwd_ref``) against ``jax.vjp`` of the XLA
  twins at every MDViT stage's (C, ch), against torch autograd of the plain
  forwards, and through the ``autograd.Function`` wiring the card uses (on the
  CPU its backward is the plain one). The Pallas backward kernels in interpret
  mode are too slow here (``tests/test_pallas_attention.py``); the twins are
  held equal to them by the JAX package's own tests.
* Train-mode ``DomainBatchNorm`` against the flax module.
* ``fast_uniform``/``hash_u32`` bit-equal to the JAX package's; the
  dropout op's counter layouts and its autograd.
* AdamW + staircase StepLR against ``optax.adamw(steplr_schedule(...))``.

fp32 on both sides, JAX at ``highest`` precision, inputs from seeded numpy.
"""
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdvit_tpu.data.augment import _hash_u32 as jax_hash_u32
from mdvit_tpu.data.augment import fast_uniform as jax_fast_uniform
from mdvit_tpu.ops.norm import DomainBatchNorm as JaxBN
from mdvit_tpu.ops.pallas_attention import factorized_attention_xla
from mdvit_tpu.ops.pallas_dwconv import cpe_conv_xla, crpe_conv_xla
from mdvit_tpu.train.optim import steplr_schedule
from mdvit_tpu_torch.ops import dwconv, kernels, layers
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import (draw_seed, dropout2d, drop_path, fast_dropout,
                                         fast_uniform, hash_u32)
from mdvit_tpu_torch.ops.norm import DomainBatchNorm
from mdvit_tpu_torch.parallel.mesh import RowShard, Shard, row_sharded, sharded
from mdvit_tpu_torch.train.optim import build_optimizer
from tests.test_torch_kernels_gpu import (ATTN_BUCKETS, ATTN_CHUNK_ROWS,
                                          ATTN_FWD_CHUNK_ROWS, attn_bucket, drawn_counters,
                                          dropout_call, formula_mask, mask_shape_of)

torch.set_num_threads(2)

STAGE_C_CH = [(64, 8), (128, 16), (320, 40), (512, 64)]
# fp32 sums in another order than XLA's (the backwards' sums run over up to
# N = 64 tokens or B·H·W = 128 pixels of O(1) terms)
TOL = dict(rtol=1e-5, atol=1e-5)
# the weight gradients sum B·H·W = 128 products of O(1) values: scale 10-ish
TOL_SUM = dict(rtol=1e-5, atol=1e-4)


def _np(rs, *shape, std=1.0):
    return (std * rs.standard_normal(shape)).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


@pytest.mark.parametrize("c,ch", STAGE_C_CH)
def test_factorized_attention_bwd_ref(c, ch):
    rs = np.random.RandomState(c)
    q, k, v, g = (_np(rs, 2, 64, c) for _ in range(4))
    scale = ch ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: factorized_attention_xla(q, k, v, ch, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = fa.factorized_attention_bwd_ref(*map(torch.from_numpy, (q, k, v, g)), ch, scale)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    # torch autograd of the plain forward, and the Function wiring
    for fn in (fa.factorized_attention_ref, fa.factorized_attention):
        tq, tk, tv = map(_leaf, (q, k, v))
        fn(tq, tk, tv, ch, scale).backward(torch.from_numpy(g))
        for t, b in zip((tq, tk, tv), want):
            np.testing.assert_allclose(t.grad.numpy(), b, **TOL)


def _chunked_attention_bwd(q, k, v, g, ch, scale):
    """The CUDA backward's two launches in plain torch, fp32 (the split plain
    versions): per chunk of ``ATTN_CHUNK_ROWS`` tokens of ch's width bucket
    the partials m_s, l_s, T_s and D_s = qᵀg; the fold over the chunks in
    their order (dT = scale·Σ D_s); then dq = scale·g·Tᵀ, dv = ks·dT and
    dk = ks ⊙ (v·dTᵀ − inner), inner = Σ_j dT ⊙ T, ks = exp(k − M) / L."""
    ws = fa.factorized_attention_bwd_partials_ref(q, k, v, g, ch)
    return fa.factorized_attention_bwd_apply_ref(k, v, g, ws, ch, scale)


# (C, ch, N): N ragged against the chunk rows (256, 128, 64, 32 for ch 8, 16,
# 40, 64; the forward's 64 at ch 64), from one chunk plus one row up to 32
# chunks
CHUNKED_CASES = [(64, 8, 257), (64, 8, 1000), (128, 16, 33), (128, 16, 257),
                 (320, 40, 1000), (512, 64, 33), (512, 64, 1000),
                 # the classifiers' widths off MDViT's, in their buckets' chunks,
                 # at N = H·W + 1 (CoaT's cls row)
                 (152, 19, 197), (176, 22, 197), (216, 27, 785), (368, 46, 197)]


@pytest.mark.parametrize("c,ch,n", CHUNKED_CASES, ids=lambda x: str(x))
def test_chunked_attention_bwd_matches_xla(c, ch, n):
    """k is scaled ×20, so each head's column maxima fall in different chunks
    and exp(m_s − M) spans many decades, and one column's maximum sits in the
    last, ragged chunk. fp32 against JAX at ``highest``: sums over up to 1000
    tokens in another order, so each output is held relative to its largest
    value."""
    rs = np.random.RandomState(n + c)
    q, k, v, g = (_np(rs, 2, n, c) for _ in range(4))
    k *= 20.0
    k[:, -1, 3] = k[:, :, 3].max() + 5.0
    rows = ATTN_CHUNK_ROWS[attn_bucket(ch)]
    assert len(np.unique(k.argmax(axis=1) // rows)) > 1 or n <= rows
    scale = ch ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: factorized_attention_xla(q, k, v, ch, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = _chunked_attention_bwd(*map(torch.from_numpy, (q, k, v, g)), ch, scale)
    for a, e in zip(got, want):
        err = np.abs(a.numpy() - e).max()
        assert err <= 1e-5 * np.abs(e).max(), (err, np.abs(e).max())


def test_attention_chunk_rows():
    """Every head width 1..64 runs in a width bucket at least as wide, a
    multiple of 4 (the kernels' 4-column register tiles); MDViT's 8, 16, 40
    and 64 as themselves. The backward's chunk of each bucket holds 2048 to
    2560 values an input, the forward's the same but at ch 64 twice that (it
    stages two inputs, not four), in rows a multiple of 4 (the 4-row register
    tiles), with MDViT's rows as before; the plain split versions cut N
    tokens into ⌈N / rows⌉ chunks."""
    assert {ch: ATTN_CHUNK_ROWS[ch] for ch in (8, 16, 40, 64)} == {
        8: 256, 16: 128, 40: 64, 64: 32}
    assert {ch: ATTN_FWD_CHUNK_ROWS[ch] for ch in (8, 16, 40, 64)} == {
        8: 256, 16: 128, 40: 64, 64: 64}
    assert sorted(ATTN_CHUNK_ROWS) == sorted(ATTN_FWD_CHUNK_ROWS) == list(ATTN_BUCKETS)
    assert max(ATTN_BUCKETS) == fa.MAX_CH and all(b % 4 == 0 for b in ATTN_BUCKETS)
    assert all(ch <= attn_bucket(ch) for ch in range(1, fa.MAX_CH + 1))
    assert [attn_bucket(ch) for ch in (8, 12, 16, 19, 22, 24, 27, 28, 32, 36, 40, 46, 60,
                                       64)] == [8, 12, 16, 20, 24, 24, 28, 28, 32, 36, 40,
                                                48, 64, 64]
    for ch, rows in ATTN_CHUNK_ROWS.items():
        assert 2048 <= rows * ch <= 2560 and rows % 4 == 0
        fwd = ATTN_FWD_CHUNK_ROWS[ch]
        assert fwd == (2 * rows if ch == 64 else rows) and fwd % 4 == 0

    def chunks(n, ch, grad=True):
        z = torch.zeros(1, n, ch)
        ws = (fa.factorized_attention_bwd_partials_ref(z, z, z, z, ch) if grad
              else fa.factorized_attention_partials_ref(z, z, ch))
        return ws.shape[1] // fa.partial_floats(ch, grad)

    assert [chunks(n, 8) for n in (1, 256, 257, 4096)] == [1, 1, 2, 16]
    assert [chunks(n, 64) for n in (33, 64, 1000)] == [2, 2, 32]
    assert [chunks(n, 16) for n in (1024, 33)] == [8, 1]
    assert chunks(256, 40) == 4
    assert [chunks(n, 64, False) for n in (33, 64, 1000)] == [1, 1, 16]
    assert [chunks(n, 8, False) for n in (257, 4096)] == [2, 16]
    assert chunks(256, 40, False) == 4


# (B, H, W, C): the stage widths at 8×8, then ragged shapes that cut the
# tiled kernels' 8×16 tiles and 32-channel slices unevenly, and C = 12
DWCONV_SHAPES = [pytest.param(2, 8, 8, c, id=str(c)) for c, _ in STAGE_C_CH] + [
    pytest.param(2, 37, 23, 40, id="2x37x23x40"), pytest.param(3, 5, 9, 24, id="3x5x9x24"),
    pytest.param(1, 64, 64, 64, id="1x64x64x64"), pytest.param(2, 9, 7, 12, id="2x9x7x12")]


@pytest.mark.parametrize("bsz,h,wd,c", DWCONV_SHAPES)
def test_cpe_conv_bwd_ref(bsz, h, wd, c):
    rs = np.random.RandomState(c + 1 + h - 8)
    x, g = _np(rs, bsz, h, wd, c), _np(rs, bsz, h, wd, c)
    w, b = _np(rs, 3, 3, c, std=(2 / 9) ** 0.5), _np(rs, c, std=0.1)
    _, vjp = jax.vjp(cpe_conv_xla, *map(jnp.asarray, (x, w, b)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = dwconv.cpe_conv_bwd_ref(*map(torch.from_numpy, (x, w, g)))
    for a, e, tol in zip(got, want, (TOL, TOL_SUM, TOL_SUM)):
        np.testing.assert_allclose(a.numpy(), e, **tol)
    for fn in (dwconv.cpe_conv_ref, dwconv.cpe_conv):
        leaves = list(map(_leaf, (x, w, b)))
        fn(*leaves).backward(torch.from_numpy(g))
        for t, e, tol in zip(leaves, want, (TOL, TOL_SUM, TOL_SUM)):
            np.testing.assert_allclose(t.grad.numpy(), e, **tol)


@pytest.mark.parametrize("bsz,h,wd,c", DWCONV_SHAPES)
def test_crpe_conv_bwd_ref(bsz, h, wd, c):
    rs = np.random.RandomState(c + 2 + h - 8)
    qkv = _np(rs, bsz, h, wd, 3 * c)
    q, v = qkv[..., :c], qkv[..., 2 * c:]
    g = _np(rs, bsz, h, wd, c)
    w, b = _np(rs, 7, 7, c, std=(2 / 49) ** 0.5), _np(rs, c, std=0.1)
    _, vjp = jax.vjp(crpe_conv_xla, *map(jnp.asarray, (q, v, w, b)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tols = (TOL, TOL, TOL_SUM, TOL_SUM)
    tqkv = torch.from_numpy(qkv)
    got = dwconv.crpe_conv_bwd_ref(tqkv[..., :c], tqkv[..., 2 * c:],
                                   *map(torch.from_numpy, (w, b, g)))
    for a, e, tol in zip(got, want, tols):
        np.testing.assert_allclose(a.numpy(), e, **tol)
    for fn in (dwconv.crpe_conv_ref, dwconv.crpe_conv):
        tqkv = _leaf(qkv)  # q and v as strided slices of one projection
        tw, tb = _leaf(w), _leaf(b)
        fn(tqkv[..., :c], tqkv[..., 2 * c:], tw, tb).backward(torch.from_numpy(g))
        grad = tqkv.grad.numpy()
        for a, e, tol in zip((grad[..., :c], grad[..., 2 * c:], tw.grad, tb.grad),
                             want, tols):
            np.testing.assert_allclose(np.asarray(a), e, **tol)
        assert not grad[..., c:2 * c].any()


def test_bf16_grads_keep_weight_dtype():
    """dw, db come back in w's dtype (fp32 sums cast once, as
    ``_cpe_vjp_bwd`` does); image gradients in the input dtype."""
    rs = np.random.RandomState(9)
    x = _leaf(_np(rs, 1, 4, 4, 16)).to(torch.bfloat16)
    w = _leaf(_np(rs, 3, 3, 16))
    b = _leaf(_np(rs, 16))
    x.retain_grad()
    out = dwconv.cpe_conv(x, w.to(torch.bfloat16), b.to(torch.bfloat16))
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert torch.isfinite(w.grad).all() and torch.isfinite(b.grad).all()


def test_no_grad_calls_skip_the_function():
    """Serving under no_grad calls the forward directly: no autograd node."""
    rs = np.random.RandomState(10)
    q = _leaf(_np(rs, 1, 16, 64))
    with torch.no_grad():
        out = fa.factorized_attention(q, q, q, 8, 1.0)
    assert out.grad_fn is None
    assert fa.factorized_attention(q, q, q, 8, 1.0).grad_fn is not None
    kernels.reset_launches()
    assert set(kernels.LAUNCHES) == {
        "factorized_attention", "cpe_conv", "crpe_conv",
        "factorized_attention_bwd", "cpe_conv_bwd", "crpe_conv_bwd", "dropout"}


def _bn_vars(rs, c):
    return {"params": {"scale": 1 + _np(rs, c, std=0.1), "bias": _np(rs, c, std=0.1)},
            "batch_stats": {"mean": _np(rs, c, std=0.1),
                            "var": np.exp(_np(rs, c, std=0.2))}}


@pytest.mark.parametrize("domains", [[2, 0, 3, 1, 2, 2], [1, 1, 3, 3, 1, 3]],
                         ids=["mixed", "absent_domains"])
def test_batch_norm_train_matches_flax(domains):
    rs = np.random.RandomState(11)
    c = 24
    x = 2.0 + 3.0 * _np(rs, 6, 5, 5, c)
    oh = np.eye(4, dtype=np.float32)[domains]
    v = _bn_vars(rs, c)
    mod = JaxBN(num_features=c, num_domains=4)
    want, upd = mod.apply(v, x, oh, use_running_average=False, mutable=["batch_stats"])
    port = DomainBatchNorm(c)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        port.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        port.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    got = port(torch.from_numpy(x), torch.from_numpy(oh), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **TOL)


@pytest.mark.parametrize("seed", [0, 0xDEADBEEF, 7])
def test_fast_uniform_bit_equal(seed):
    want = np.asarray(jax_fast_uniform(jnp.uint32(seed), (3, 5, 7)))
    got = fast_uniform(seed, (3, 5, 7)).numpy()
    np.testing.assert_array_equal(got, want)
    x = np.random.RandomState(seed % 1000).randint(0, 2 ** 32, 4096, dtype=np.int64)
    np.testing.assert_array_equal(
        hash_u32(torch.from_numpy(x)).numpy(),
        np.asarray(jax_hash_u32(jnp.asarray(x.astype(np.uint32)))).astype(np.int64))


def test_dropouts():
    """Identity at rate 0 or in eval; in train, kept values scaled by
    1/keep and masks of the documented shapes."""
    x = torch.ones(4, 6, 6, 32)
    gen = torch.Generator().manual_seed(0)
    for fn in (fast_dropout, drop_path, dropout2d):
        assert fn(x, 0.0, True, None) is x and fn(x, 0.5, False, None) is x
        y = fn(x, 0.5, True, gen)
        assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert (drop_path(x, 0.5, True, gen).flatten(1).std(dim=1) == 0).all()
    assert (dropout2d(x, 0.5, True, gen).flatten(1, 2).std(dim=1) == 0).all()
    with pytest.raises(ValueError):
        fast_dropout(x, 0.1, True, None)


@pytest.mark.parametrize("fn,mask_shape", [(fast_dropout, (4, 6, 6, 32)),
                                           (drop_path, (4, 1, 1, 1)),
                                           (dropout2d, (4, 1, 1, 32))])
def test_dropout_masks_are_hashed_counters(fn, mask_shape):
    """Each train-mode call draws one uint32 seed from ``gen`` and keeps the
    elements whose hashed counter (``fast_uniform``) falls below keep."""
    x = torch.randn(4, 6, 6, 32, generator=torch.Generator().manual_seed(1))
    keep = 1.0 - 0.3
    seed = draw_seed(torch.Generator().manual_seed(3))
    mask = (fast_uniform(seed, mask_shape) < keep).expand_as(x)
    got = fn(x, 0.3, True, torch.Generator().manual_seed(3))
    assert torch.equal(got, torch.where(mask, x / keep, torch.zeros_like(x)))


# (mask, x's shape, row0, (mode, rank, ranks, rows) of the row shard, the
# row-sharded axis): the per-sample and per-channel broadcasts, a
# data-parallel rank's rows, both context modes, grid rows (unequal blocks),
# tokens and UTNet's attention probabilities (axis 2)
DROPOUT_LAYOUTS = [
    ("element", (2, 3, 4, 8), 0, None, 1),
    ("element", (2, 3, 4, 8), 3, None, 1),
    ("sample", (2, 3, 4, 8), 3, None, None),
    ("channel", (2, 3, 4, 8), 3, None, None),
    ("element", (2, 12, 8), 1, ("stage", 1, 2, ()), 1),
    ("element", (2, 3, 4, 8), 1, ("e2e", 1, 2, (2, 1)), 1),
    ("element", (2, 4, 4, 8), 0, ("e2e", 0, 2, (2, 1)), 1),
    ("element", (2, 12, 8), 2, ("e2e", 1, 2, ()), 1),
    ("element", (2, 3, 12, 5), 1, ("e2e", 1, 3, ()), 2),
]


@pytest.mark.parametrize("kind,shape,row0,ctx,axis", DROPOUT_LAYOUTS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_dropout_op_layout_gives_the_counters(kind, shape, row0, ctx, axis):
    """``mdvit::dropout``'s integers (key, row, stride, period) give every
    element of x the counter its mask was drawn at before the op
    (``drawn_counters``: the shard's first counter + row-major ones of
    element, per-sample and per-channel masks, the seed folded with the
    shard index in ``"stage"`` mode, the unsharded tensor's in ``"e2e"``
    mode); the public dropouts are the op at those integers, and its output
    is the formula's."""
    seed, rate = 0xC0FFEE42, 0.4
    keep = 1.0 - rate
    shard = RowShard(None, ctx[1], ctx[2], ctx[0], ctx[3]) if ctx else None
    with mock.patch.object(layers, "draw_seed", lambda gen: seed), \
            sharded(Shard(None, row0, None)), row_sharded(shard):
        key, row, stride, period = layers._counter_layout(
            shape, mask_shape_of(kind, shape), None, axis if kind == "element" else None)
        got = dropout_call(kind, torch.ones(shape), rate, axis)
    e = torch.arange(math.prod(shape))
    counters = (key + e // row * stride + e % row % period) & 0xFFFFFFFF
    want = drawn_counters(kind, shape, seed, row0, shard, axis)
    assert torch.equal(counters.reshape(shape), want.expand(shape))
    out = torch.ops.mdvit.dropout(torch.ones(shape), keep, key, row, stride, period)
    mask = formula_mask(kind, shape, seed, keep, row0, shard, axis)
    assert torch.equal(out, torch.where(mask, 1.0 / keep, 0.0).expand(shape))
    assert torch.equal(got, out)


def test_dropout_op_gradcheck():
    """The op's registered autograd (the same op on the gradient) against
    finite differences in fp64, at an element and a per-channel layout."""
    x = torch.randn(2, 3, 4, dtype=torch.float64, requires_grad=True)
    for layout in ((0x1234, 12, 12, 12), (0x1234, 12, 4, 4)):
        assert torch.autograd.gradcheck(
            lambda t: torch.ops.mdvit.dropout(t, 0.7, *layout), (x,))


def test_adamw_steplr_matches_optax():
    """Three updates with a staircase boundary after two (lr 1e-4, 1e-4,
    5e-5), weight decay 0.05, on fixed numpy gradients."""
    rs = np.random.RandomState(12)
    p0 = {"a": _np(rs, 5, 3), "b": _np(rs, 7)}
    grads = [{k: _np(rs, *v.shape) for k, v in p0.items()} for _ in range(3)]
    tx = optax.adamw(steplr_schedule(1e-4, 1, 0.5, 2), b1=0.9, b2=0.999,
                     eps=1e-8, weight_decay=0.05)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt, sched = build_optimizer(module, steps_per_epoch=2, step_size_epochs=1)
    lrs = []
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        lrs.append(opt.param_groups[0]["lr"])
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        # each update may round an O(1) parameter one fp32 step (1.2e-7) apart;
        # a wrong lr or decay would move it by ~5e-5
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                       rtol=0, atol=4e-7)
    np.testing.assert_allclose(lrs, [1e-4, 1e-4, 5e-5])
