"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips inside the test when there is no
CUDA card. The file imports only torch, numpy and the port, so it runs on a
machine without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""
import math
from unittest import mock

import numpy as np
import pytest
import torch

import torch_cp
from mdvit_tpu_torch.device import no_tf32
from mdvit_tpu_torch.ops import dwconv, kernels, layers
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import dropout2d, drop_path, fast_dropout, hash_u32
from mdvit_tpu_torch.parallel.mesh import RowShard, Shard, row_sharded, sharded

torch.set_num_threads(2)

STAGE_C_CH = [(64, 8), (128, 16), (320, 40), (512, 64)]
FORWARD = ("factorized_attention", "cpe_conv", "crpe_conv")
BACKWARD = ("factorized_attention_bwd", "cpe_conv_bwd", "crpe_conv_bwd")
OPS = FORWARD + BACKWARD + ("dropout",)


def _counts(names):
    return {n: kernels.LAUNCHES[n] for n in names}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _weights_apart(grads, w):
    """A CPE or CRPE backward op's outputs with its stacked (K·K + 1, C)
    fp32 weight gradient split into dw (K, K, C) and db (C,)."""
    *image, dwb = grads
    return (*image, dwb[:-1].view(w.shape), dwb[-1])


# kernel vs plain version, both fp32 inside: fp32 differs in summation order
# (and FMA contraction); bf16 by a rounding step of the output
GPU_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}
# gradients: dw, db sum 128 products of O(1) terms in another order (fp32),
# then bf16 rounds them once to w's dtype (a step of 2⁻⁷ of their ~10 scale)
GRAD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
            torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -4)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ch", STAGE_C_CH)
def test_kernels_match_plain_on_card(c, ch, dtype):
    _need_card()
    rs = np.random.RandomState(c)
    qkv = torch.from_numpy(rs.standard_normal((2, 64, 3 * c)).astype(np.float32))
    qkv = qkv.to("cuda", dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    kernels.reset_launches()
    got = fa.factorized_attention(q, k, v, ch, ch ** -0.5)
    want = fa.factorized_attention_ref(q, k, v, ch, ch ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), **GPU_TOL[dtype])
    gq, gv = q.unflatten(1, (8, 8)), v.unflatten(1, (8, 8))
    w3 = torch.randn(3, 3, c, generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
    w7 = torch.randn(7, 7, c, generator=torch.Generator().manual_seed(2)).to("cuda", dtype)
    b = torch.randn(c, generator=torch.Generator().manual_seed(3)).to("cuda", dtype)
    x = gq.contiguous()
    torch.testing.assert_close(dwconv.cpe_conv(x, w3, b).float(),
                               dwconv.cpe_conv_ref(x, w3, b).float(), **GPU_TOL[dtype])
    torch.testing.assert_close(dwconv.crpe_conv(gq, gv, w7, b).float(),
                               dwconv.crpe_conv_ref(gq, gv, w7, b).float(),
                               **GPU_TOL[dtype])
    assert _counts(FORWARD) == {"factorized_attention": 1, "cpe_conv": 1, "crpe_conv": 1}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    q = torch.randn(1, 16, 144, device="cuda")
    for ch in (72, 144, 0, 5):  # wider than 64, none, not dividing C
        with pytest.raises(ValueError):
            fa.factorized_attention(q, q, q, ch, 1.0)
        with pytest.raises(ValueError):
            torch.ops.mdvit.factorized_attention_bwd(q, q, q, q, ch, 1.0)
    with pytest.raises(TypeError):
        fa.factorized_attention(q.half(), q.half(), q.half(), 8, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_every_width_matches_plain_on_card(dtype):
    """A and A′ at every head width 1..64, 3 heads, N = 37 (a ragged chunk),
    q, k, v slices of one (B, N, 3C) tensor: against the plain versions,
    one counted call each."""
    _need_card()
    for ch in range(1, fa.MAX_CH + 1):
        c = 3 * ch
        rs = np.random.RandomState(ch)
        qkv = torch.from_numpy(rs.standard_normal((2, 37, 3 * c)).astype(np.float32))
        qkv = qkv.to("cuda", dtype)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        g = torch.from_numpy(rs.standard_normal((2, 37, c)).astype(np.float32)).to("cuda", dtype)
        kernels.reset_launches()
        with torch.no_grad():
            got = fa.factorized_attention(q, k, v, ch, ch ** -0.5)
        grads = torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ch, ch ** -0.5)
        torch.cuda.synchronize()
        assert _counts(("factorized_attention", "factorized_attention_bwd")) == {
            "factorized_attention": 1, "factorized_attention_bwd": 1}, ch
        want = fa.factorized_attention_ref(q, k, v, ch, ch ** -0.5)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATTN_BWD_REL_TOL[dtype] * want.float().abs().max().item(), (ch, err)
        for a, e in zip(grads, fa.factorized_attention_bwd_ref(q, k, v, g, ch, ch ** -0.5)):
            err = (a.float() - e.float()).abs().max().item()
            assert err <= ATTN_BWD_REL_TOL[dtype] * e.float().abs().max().item(), (ch, err)


@pytest.mark.gpu
def test_model_forward_on_card_goes_through_the_kernels():
    """A small full-width MDViT on the card: one launch of each kernel per
    serial block, no backward and no dropout launch, and the same logits as
    through the plain versions."""
    from mdvit_tpu_torch.models.registry import build_mdvit

    _need_card()
    model = build_mdvit(img_size=64, num_domains=4, device="cuda",
                        num_layers=(1, 1, 1, 1))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.standard_normal((4, 64, 64, 3)).astype(np.float32)).cuda()
    oh = torch.eye(4, device="cuda")[[1, 3, 0, 2]]
    kernels.reset_launches()
    with torch.no_grad(), no_tf32():
        got = model(x, oh)["seg"][0]
    torch.cuda.synchronize()
    assert _counts(FORWARD) == {"factorized_attention": 8, "cpe_conv": 8, "crpe_conv": 8}
    assert _counts(BACKWARD + ("dropout",)) == {n: 0 for n in BACKWARD + ("dropout",)}
    with mock.patch.object(fa, "factorized_attention", fa.factorized_attention_ref), \
            mock.patch.object(dwconv, "cpe_conv", dwconv.cpe_conv_ref), \
            mock.patch.object(dwconv, "crpe_conv", dwconv.crpe_conv_ref), \
            torch.no_grad(), no_tf32():
        want = model(x, oh)["seg"][0]
    # 8 blocks carry each kernel's last-bit fp32 differences; relative to scale
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ch", STAGE_C_CH)
def test_backward_kernels_match_plain_on_card(c, ch, dtype):
    """The three forward ops' registered autograd on the card: gradients
    through the backward kernels against the plain backwards on the same
    inputs, and dw/db the same bits on a second call (no atomics)."""
    _need_card()
    rs = np.random.RandomState(c + 7)

    def leaf(*shape, std=1.0):
        a = (std * rs.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dtype).requires_grad_(True)

    qkv, g = leaf(2, 64, 3 * c), leaf(2, 64, c).detach()
    w3, w7 = leaf(3, 3, c, std=0.5), leaf(7, 7, c, std=0.2)
    b = leaf(c, std=0.1)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    grid = (2, 8, 8, c)
    kernels.reset_launches()
    got = torch.autograd.grad(fa.factorized_attention(q, k, v, ch, ch ** -0.5), qkv, g)[0]
    want = fa.factorized_attention_bwd_ref(q, k, v, g, ch, ch ** -0.5)
    for a, e in zip(got.split(c, dim=-1), want):
        torch.testing.assert_close(a.float(), e.float(), **GPU_TOL[dtype])

    x, gg = q.detach().reshape(grid).contiguous(), g.reshape(grid)
    cpe_grads = []
    for _ in range(2):
        xl = x.clone().requires_grad_(True)
        cpe_grads.append(torch.autograd.grad(dwconv.cpe_conv(xl, w3, b), (xl, w3, b), gg))
    want = dwconv.cpe_conv_bwd_ref(x, w3.detach(), gg)
    for a, e in zip(cpe_grads[0], want):
        torch.testing.assert_close(a.float(), e.float(), **GRAD_TOL[dtype])
    for a, e in zip(cpe_grads[0], cpe_grads[1]):
        assert torch.equal(a, e)

    qg, vg = q.reshape(grid), v.reshape(grid)
    got = torch.autograd.grad(dwconv.crpe_conv(qg, vg, w7, b), (qkv, w7, b), gg)
    want = dwconv.crpe_conv_bwd_ref(qg.detach(), vg.detach(), w7.detach(), b.detach(), gg)
    dqkv = got[0].reshape(grid[:3] + (3 * c,))
    for a, e in zip((dqkv[..., :c], dqkv[..., 2 * c:], got[1], got[2]), want):
        torch.testing.assert_close(a.float(), e.float(), **GRAD_TOL[dtype])
    assert _counts(BACKWARD) == {"factorized_attention_bwd": 1, "cpe_conv_bwd": 2,
                                 "crpe_conv_bwd": 1}


@pytest.mark.gpu
def test_fp32_serving_forward_runs_without_tf32_on_card():
    """With both global TF32 flags on (cuDNN's is on by PyTorch's default),
    the fp32 forward from ``make_forward`` on the card gives the logits of
    the same weights on the CPU within 1e-4 of their scale, as
    ``test_model_forward_on_card_goes_through_the_kernels`` holds kernels to;
    the same model called directly with TF32 on misses that; and the flags
    read True again afterwards."""
    from mdvit_tpu_torch.models.registry import build_mdvit
    from mdvit_tpu_torch.predict import make_forward

    _need_card()
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        kw = dict(img_size=64, num_domains=4, num_layers=(1, 1, 1, 1))
        card, cpu = build_mdvit(device="cuda", **kw), build_mdvit(device="cpu", **kw)
        cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
        logits = []
        for m in (card, cpu):
            m.register_forward_hook(lambda mod, args, out: logits.append(out["seg"][0]))
        rs = np.random.RandomState(3)
        x = torch.from_numpy(rs.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
        oh = torch.eye(4)[[2, 0]]
        probs = make_forward(card)(x.cuda(), oh.cuda())
        make_forward(cpu)(x, oh)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        got, want = logits[0].cpu(), logits[1]
        limit = 1e-4 * want.abs().max().item()
        assert probs.shape == (2, 64, 64) and torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= limit
        from mdvit_tpu_torch.data.preprocess import normalize
        with torch.no_grad():
            tf32 = card(normalize(x.cuda()), oh.cuda(), train=False, aux_mode="none")
        assert (tf32["seg"][0].cpu() - want).abs().max().item() > limit
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


# the width buckets of the factorized-attention kernels (``dispatch_ch`` in
# factorized_attention.cu: a head of width ch runs in the first bucket
# CH >= ch, its columns past ch staged as zeros) and the token rows of a
# chunk by bucket (``AttnChunk<CH, kGrad>::kRows``), as the wrapper's mirror
# has them; they set the chunks of the plain split versions, and
# ``test_attention_workspace_matches_chunk_rows_on_card`` holds them to the
# library
ATTN_BUCKETS = fa.ATTN_BUCKETS
attn_bucket = fa.attn_bucket
ATTN_CHUNK_ROWS = fa.ATTN_CHUNK_ROWS
ATTN_FWD_CHUNK_ROWS = fa.ATTN_FWD_CHUNK_ROWS
# The factorized-attention kernels' chunked split, (B, N, C, ch, k scale): N
# ragged against the chunk rows (``ATTN_CHUNK_ROWS``, ``ATTN_FWD_CHUNK_ROWS``),
# k ×20 so that the column maxima fall in different
# chunks and one in the last, ragged chunk; and N = 4096 at ch 8 with B = 1
# (16 chunks); then the classifiers' head widths that MDViT does not send, at
# their N = H·W + 1 (CoaT's cls row) and N = H·W (MPViT) at 224²
ATTN_SPLIT_CASES = [(2, 257, 64, 8, 20.0), (2, 1000, 64, 8, 20.0), (2, 33, 128, 16, 20.0),
                    (2, 257, 128, 16, 20.0), (2, 1000, 320, 40, 20.0), (2, 33, 512, 64, 20.0),
                    (2, 1000, 512, 64, 20.0), (1, 4096, 64, 8, 1.0), (1, 4096, 64, 8, 20.0),
                    (2, 785, 96, 12, 20.0), (1, 3137, 152, 19, 20.0), (2, 197, 152, 19, 20.0),
                    (2, 196, 176, 22, 20.0), (2, 197, 192, 24, 20.0), (2, 785, 216, 27, 20.0),
                    (2, 50, 216, 27, 20.0), (2, 785, 224, 28, 20.0), (2, 197, 256, 32, 20.0),
                    (2, 50, 288, 36, 20.0), (2, 197, 368, 46, 20.0), (2, 49, 480, 60, 20.0),
                    (2, 50, 320, 40, 20.0)]
# relative to each output's largest value. fp32: the kernel sums a column over
# 64-row groups, then over chunks in order, where cuBLAS's einsum blocks the
# 4096 tokens another way; both are blocked sums whose rounding grows with the
# square root of the terms of a block, far below 1e-5 (the CPU test of the
# same algorithm reads ≤ 1.2e-6 at N = 1000). bf16: both sides compute in fp32
# and round once, so they differ by at most one rounding step, 2⁻⁸ of a value
# at most 2⁻⁷ of the largest.
ATTN_BWD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7 + 1e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_SPLIT_CASES, ids=lambda c: "x".join(map(str, c[:4])) + f"k{c[4]:g}")
def test_attention_bwd_split_matches_plain_on_card(case, dtype):
    """A′'s partials and apply kernels against the plain backward: q, k, v
    strided slices of one (B, N, 3C) tensor, g a non-contiguous view, one
    call counted, the same bits on a second call."""
    _need_card()
    bsz, n, c, ch, k_scale = case
    rs = np.random.RandomState(n + c)
    qkv = rs.standard_normal((bsz, n, 3 * c)).astype(np.float32)
    qkv[..., c:2 * c] *= k_scale
    qkv[:, -1, c + 3] = qkv[:, :, c + 3].max() + 5.0
    qkv = torch.from_numpy(qkv).to("cuda", dtype)
    wide = torch.from_numpy(rs.standard_normal((bsz, n, 2 * c)).astype(np.float32))
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    g = wide.to("cuda", dtype)[..., c:]
    assert not g.is_contiguous()
    kernels.reset_launches()
    got = torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ch, ch ** -0.5)
    again = torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ch, ch ** -0.5)
    torch.cuda.synchronize()
    want = fa.factorized_attention_bwd_ref(q, k, v, g, ch, ch ** -0.5)
    for a, e in zip(got, want):
        err = (a.float() - e.float()).abs().max().item()
        assert err <= ATTN_BWD_REL_TOL[dtype] * e.float().abs().max().item(), err
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    assert kernels.LAUNCHES["factorized_attention_bwd"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_SPLIT_CASES, ids=lambda c: "x".join(map(str, c[:4])) + f"k{c[4]:g}")
def test_attention_fwd_split_matches_plain_on_card(case, dtype):
    """A's partials and apply kernels against the plain forward on
    ``ATTN_SPLIT_CASES``: q, k, v strided slices of one (B, N, 3C) tensor,
    one call counted, the same bits on a second call. The tolerance is A′'s
    (``ATTN_BWD_REL_TOL``), for the same reason: the kernel sums a column over
    row groups, then over chunks in order, where the plain version's einsum
    blocks the tokens another way; in bf16 both round one fp32 value once."""
    _need_card()
    bsz, n, c, ch, k_scale = case
    rs = np.random.RandomState(n + c + 1)
    qkv = rs.standard_normal((bsz, n, 3 * c)).astype(np.float32)
    qkv[..., c:2 * c] *= k_scale
    qkv[:, -1, c + 3] = qkv[:, :, c + 3].max() + 5.0
    qkv = torch.from_numpy(qkv).to("cuda", dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    kernels.reset_launches()
    with torch.no_grad():
        got = fa.factorized_attention(q, k, v, ch, ch ** -0.5)
        count = kernels.LAUNCHES["factorized_attention"]
        again = fa.factorized_attention(q, k, v, ch, ch ** -0.5)
    torch.cuda.synchronize()
    want = fa.factorized_attention_ref(q, k, v, ch, ch ** -0.5)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_BWD_REL_TOL[dtype] * want.float().abs().max().item(), err
    assert got.dtype == dtype and got.is_contiguous() and torch.equal(got, again)
    assert count == 1


@pytest.mark.gpu
def test_attention_workspace_matches_chunk_rows_on_card():
    """The library's workspace floats per (batch element, head) at every head
    width 1..64: ⌈N / rows⌉ chunks of 2·CH + CH² (forward) or 2·CH + 2·CH²
    (backward), CH the width's bucket, with the rows of
    ``ATTN_FWD_CHUNK_ROWS`` and ``ATTN_CHUNK_ROWS``; -1 for a head width
    outside 1..64."""
    _need_card()
    lib = kernels.library("factorized_attention")
    for grad, table in ((0, ATTN_FWD_CHUNK_ROWS), (1, ATTN_CHUNK_ROWS)):
        for ch in range(1, fa.MAX_CH + 1):
            wide = attn_bucket(ch)
            for n in (1, 33, 50, 64, 256, 257, 785, 1000, 3137, 4096):
                want = -(-n // table[wide]) * (2 * wide + (1 + grad) * wide * wide)
                assert lib.mdvit_factorized_attention_workspace(n, ch, grad) == want, (ch, n)
        for ch in (0, 65, 72):
            assert lib.mdvit_factorized_attention_workspace(64, ch, grad) == -1


# dw, db of CPE and CRPE: fp32 sums over B·H·W (up to 9216 products here) in
# another order than the plain version's, relative to their largest value
CRPE_WEIGHT_REL_TOL = 1e-4
# ragged tiles and channel slices (H, W not multiples of the 8×16 tile, C not
# of the 32-channel slice), C = 12, 6 and 5 taking the narrower copy widths,
# and 3x64x48 whose 72 tiles the reduce splits between warp rows
TILED_SHAPES = [(2, 37, 23, 40), (3, 5, 9, 24), (1, 64, 64, 64), (2, 9, 7, 12),
                (2, 11, 19, 6), (1, 13, 17, 5), (3, 64, 48, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TILED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_crpe_tiled_kernels_match_plain_on_card(shape, dtype):
    """C and C′ on ``TILED_SHAPES``; q and v are strided slices of one
    (B, H, W, 3C) tensor; dw and db are the same bits on a second call."""
    _need_card()
    bsz, h, wd, c = shape
    rs = np.random.RandomState(sum(shape))

    def rand(*s, std=1.0):
        a = (std * rs.standard_normal(s)).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dtype)

    qkv = rand(bsz, h, wd, 3 * c)
    q, v = qkv[..., :c], qkv[..., 2 * c:]
    w, b, g = rand(7, 7, c, std=(2 / 49) ** 0.5), rand(c, std=0.1), rand(bsz, h, wd, c)
    kernels.reset_launches()
    torch.testing.assert_close(dwconv.crpe_conv(q, v, w, b).float(),
                               dwconv.crpe_conv_ref(q, v, w, b).float(), **GPU_TOL[dtype])
    got = _weights_apart(torch.ops.mdvit.crpe_conv_bwd(q, v, w, b, g), w)
    again = _weights_apart(torch.ops.mdvit.crpe_conv_bwd(q, v, w, b, g), w)
    torch.cuda.synchronize()
    want = dwconv.crpe_conv_bwd_ref(q, v, w, b, g)
    for a, e in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.float(), e.float(), **GPU_TOL[dtype])
    for a, e in zip(got[2:], want[2:]):
        err = (a - e).abs().max().item()
        assert err <= CRPE_WEIGHT_REL_TOL * e.abs().max().item(), err
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    assert _counts(("crpe_conv", "crpe_conv_bwd")) == {"crpe_conv": 1, "crpe_conv_bwd": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TILED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cpe_tiled_kernels_match_plain_on_card(shape, dtype):
    """B and B′ on ``TILED_SHAPES``, with x contiguous and as a strided slice
    of a (B, H, W, 3C) tensor; dx, dw and db are the same bits on a second
    call."""
    _need_card()
    bsz, h, wd, c = shape
    rs = np.random.RandomState(sum(shape) + 1)

    def rand(*s, std=1.0):
        a = (std * rs.standard_normal(s)).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dtype)

    wide = rand(bsz, h, wd, 3 * c)
    w, b, g = rand(3, 3, c, std=(2 / 9) ** 0.5), rand(c, std=0.1), rand(bsz, h, wd, c)
    kernels.reset_launches()
    for x in (wide[..., c:2 * c].contiguous(), wide[..., c:2 * c]):
        torch.testing.assert_close(dwconv.cpe_conv(x, w, b).float(),
                                   dwconv.cpe_conv_ref(x, w, b).float(), **GPU_TOL[dtype])
        got = _weights_apart(torch.ops.mdvit.cpe_conv_bwd(x, w, g), w)
        again = _weights_apart(torch.ops.mdvit.cpe_conv_bwd(x, w, g), w)
        torch.cuda.synchronize()
        want = dwconv.cpe_conv_bwd_ref(x, w, g)
        torch.testing.assert_close(got[0].float(), want[0].float(), **GPU_TOL[dtype])
        for a, e in zip(got[1:], want[1:]):
            err = (a - e).abs().max().item()
            assert err <= CRPE_WEIGHT_REL_TOL * e.abs().max().item(), err
        assert all(torch.equal(a, e) for a, e in zip(got, again))
    assert _counts(("cpe_conv", "cpe_conv_bwd")) == {"cpe_conv": 2, "cpe_conv_bwd": 4}


# CoaT's CPE and CRPE inputs: the image rows of (B, H·W + 1, ·) tokens, so
# views whose batch stride is (H·W + 1) rows and whose first pixel is one row
# in; (B, H, W, C) at the classifiers' widths and 224²'s 56², 28², 14², 7²
COAT_VIEW_SHAPES = [(2, 7, 7, 152), (2, 14, 14, 216), (2, 28, 28, 152), (2, 56, 56, 64),
                    (2, 7, 7, 320), (2, 14, 14, 96), (2, 7, 7, 480)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", COAT_VIEW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dwconv_on_coat_views_on_card(shape, dtype):
    """B, B′, C and C′ on CoaT's views: x = tokens[:, 1:] of (B, H·W + 1, C)
    tokens, q and v = qkv[:, 1:] slices of a (B, H·W + 1, 3C) projection,
    unflattened to (B, H, W, C); against the plain versions, dw and db the
    same bits on a second call."""
    _need_card()
    bsz, h, wd, c = shape
    rs = np.random.RandomState(sum(shape) + 2)

    def rand(*s, std=1.0):
        a = (std * rs.standard_normal(s)).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dtype)

    x = rand(bsz, h * wd + 1, c)[:, 1:].unflatten(1, (h, wd))
    qkv = rand(bsz, h * wd + 1, 3 * c)[:, 1:].unflatten(1, (h, wd))
    q, v = qkv[..., :c], qkv[..., 2 * c:]
    assert not (x.is_contiguous() or q.is_contiguous())
    w3, w7 = rand(3, 3, c, std=(2 / 9) ** 0.5), rand(7, 7, c, std=(2 / 49) ** 0.5)
    b, g = rand(c, std=0.1), rand(bsz, h, wd, c)
    kernels.reset_launches()
    torch.testing.assert_close(dwconv.cpe_conv(x, w3, b).float(),
                               dwconv.cpe_conv_ref(x, w3, b).float(), **GPU_TOL[dtype])
    torch.testing.assert_close(dwconv.crpe_conv(q, v, w7, b).float(),
                               dwconv.crpe_conv_ref(q, v, w7, b).float(), **GPU_TOL[dtype])
    for run, plain, w, n_image in (
            (lambda: torch.ops.mdvit.cpe_conv_bwd(x, w3, g),
             lambda: dwconv.cpe_conv_bwd_ref(x, w3, g), w3, 1),
            (lambda: torch.ops.mdvit.crpe_conv_bwd(q, v, w7, b, g),
             lambda: dwconv.crpe_conv_bwd_ref(q, v, w7, b, g), w7, 2)):
        got, again = _weights_apart(run(), w), _weights_apart(run(), w)
        torch.cuda.synchronize()
        want = plain()
        for a, e in zip(got[:n_image], want[:n_image]):
            torch.testing.assert_close(a.float(), e.float(), **GPU_TOL[dtype])
        for a, e in zip(got[n_image:], want[n_image:]):
            err = (a - e).abs().max().item()
            assert err <= CRPE_WEIGHT_REL_TOL * e.abs().max().item(), err
        assert all(torch.equal(a, e) for a, e in zip(got, again))
    assert _counts(FORWARD[1:] + BACKWARD[1:]) == {
        "cpe_conv": 1, "crpe_conv": 1, "cpe_conv_bwd": 2, "crpe_conv_bwd": 2}


@pytest.mark.gpu
def test_dropout_masks_equal_on_card_and_cpu():
    """One generator seed gives the same masks on a card as on the CPU: the
    masks are hashed on the input's device, not drawn on the host. The kept
    values may differ by a rounding step: CUDA may divide by the scalar keep
    as a product with its reciprocal."""
    _need_card()
    x = torch.randn(4, 6, 6, 32, generator=torch.Generator().manual_seed(1))
    for fn in (fast_dropout, drop_path, dropout2d):
        want = fn(x, 0.3, True, torch.Generator().manual_seed(5))
        got = fn(x.cuda(), 0.3, True, torch.Generator().manual_seed(5))
        assert got.is_cuda
        assert torch.equal(got.cpu() == 0, want == 0)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2 ** -22, atol=0)


def row_block_counters(shape, row0: int, ctx, axis: int, device="cpu") -> torch.Tensor:
    """The counters of a rank's block of a tensor row-sharded along ``axis``
    in ``"e2e"`` mode, written out: the unsharded tensor's, sample row0 + b,
    the axis's global index (the rank's first row or token, from the row
    split) + a, the other axes as they are."""
    b, a = shape[0], shape[axis]
    pre, post = math.prod(shape[1:axis]), math.prod(shape[axis + 1:])
    split = ctx.split(a, tokens=len(shape) - axis != 3)
    start = sum(split[:ctx.index])
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    outer = (row0 + ar(b))[:, None] * pre + ar(pre)[None, :]
    idx = (outer * (sum(split) * post))[:, :, None, None] \
        + ((start + ar(a)) * post)[None, None, :, None] + ar(post)[None, None, None, :]
    return idx.reshape(shape)


def mask_shape_of(kind: str, shape) -> tuple:
    """The mask of an element dropout, DropPath (a draw a sample) or
    Dropout2d (a draw a sample and channel) of x of ``shape``."""
    shape = tuple(shape)
    return {"element": shape, "sample": shape[:1] + (1,) * (len(shape) - 1),
            "channel": shape[:1] + (1,) * (len(shape) - 2) + shape[-1:]}[kind]


def dropout_call(kind: str, x, rate: float, axis):
    if kind == "element":
        return fast_dropout(x, rate, True, None, row_axis=axis or 1)
    return (drop_path if kind == "sample" else dropout2d)(x, rate, True, None)


def drawn_counters(kind: str, shape, seed: int, row0: int, ctx, axis,
                   device="cpu") -> torch.Tensor:
    """The counters, the seed's hash base added (mod 2³²), at which the port
    drew a dropout's mask before ``mdvit::dropout``: the mask's row-major
    ones from the shard's first (the seed folded with the shard index in
    ``"stage"`` mode), or the unsharded tensor's in ``"e2e"`` mode."""
    mask_shape = mask_shape_of(kind, shape)
    if ctx is not None and ctx.mode == "e2e" and kind == "element":
        counters = row_block_counters(shape, row0, ctx, axis, device)
    else:
        if ctx is not None and kind == "element":
            seed ^= (ctx.index * 0x9E3779B9) & 0xFFFFFFFF
        counters = row0 * math.prod(mask_shape[1:]) + torch.arange(
            math.prod(mask_shape), device=device).reshape(mask_shape)
    return (counters + (((seed & 0xFFFFFFFF) * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF


def formula_mask(kind: str, shape, seed: int, keep: float, row0: int, ctx, axis,
                 device="cpu") -> torch.Tensor:
    """The mask as the port drew it before ``mdvit::dropout``: the uniforms
    of ``fast_uniform`` (``hash_u32`` of the drawn counters) below keep."""
    counters = drawn_counters(kind, shape, seed, row0, ctx, axis, device)
    return (hash_u32(counters) >> 8).float() * (1.0 / (1 << 24)) < keep


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal bit for bit, NaN in the same places (a NaN's payload aside)."""
    nan = want.isnan()
    assert got.dtype == want.dtype and torch.equal(got.isnan(), nan)
    ints = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16}[got.dtype]
    assert torch.equal(got[~nan].view(ints), want[~nan].view(ints))


# (mask, x's shape, row0, (mode, rank, ranks, rows) of the row shard, the
# row-sharded axis): the three masks, a data-parallel rank's rows, both
# context modes at grid rows (unequal blocks), tokens and UTNet's attention
# probabilities (axis 2); odd sizes leave a tail past the last 16-byte vector
DROPOUT_CARD_LAYOUTS = [
    ("element", (4, 16, 16, 64), 0, None, 1),
    ("element", (4, 16, 16, 64), 3, None, 1),
    ("sample", (4, 16, 16, 64), 3, None, None),
    ("channel", (4, 16, 16, 64), 3, None, None),
    ("element", (3, 5, 7, 9), 2, None, 1),
    ("channel", (3, 5, 7, 9), 2, None, None),
    ("element", (4, 64, 40), 1, ("stage", 1, 2, ()), 1),
    ("element", (4, 6, 8, 64), 1, ("e2e", 1, 2, (2, 1)), 1),
    ("element", (4, 48, 40), 2, ("e2e", 1, 2, ()), 1),
    ("element", (2, 4, 48, 33), 1, ("e2e", 1, 3, ()), 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.1, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("case", DROPOUT_CARD_LAYOUTS,
                         ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}-r{c[2]}-"
                                       f"{c[3][0] + str(c[4]) if c[3] else 'whole'}")
def test_dropout_kernel_bit_equal_to_formula_on_card(case, dtype, rate):
    """Each dropout through ``mdvit::dropout``'s kernel against the torch
    formula it replaced, ``where(mask, x / keep, 0)`` with the mask hashed
    at the old counters, on the card: the output and the gradient (where's
    backward, then the divide's) bit for bit, from a 16-byte aligned x, from
    one that is not (the kernel's one-element path), and with a launch cut
    to two rows (the launches a tensor of 2³¹ elements or more takes); the
    op's plain version on the card too. fp64 (the context-parallel fp64
    reference steps) scales by the fp64 reciprocal."""
    _need_card()
    kind, shape, row0, ctx, axis = case
    shard = RowShard(None, ctx[1], ctx[2], ctx[0], ctx[3]) if ctx else None
    seed, keep = 0x9D2C5680, 1.0 - rate
    gen = torch.Generator().manual_seed(sum(shape))
    n = math.prod(shape)
    buf = torch.randn(2 * n + 1, generator=gen).to("cuda", dtype)
    g = torch.randn(shape, generator=gen).to("cuda", dtype)
    mask = formula_mask(kind, shape, seed, keep, row0, shard, axis, "cuda")
    with mock.patch.object(layers, "draw_seed", lambda _: seed), \
            sharded(Shard(None, row0, None)), row_sharded(shard):
        layout = layers._counter_layout(shape, mask_shape_of(kind, shape), None,
                                        axis if kind == "element" else None)
    row = layout[1]
    assert n // row > 2
    for x, launch in ((buf[:n], layers._LAUNCH_ELEMENTS), (buf[n + 1:], layers._LAUNCH_ELEMENTS),
                      (buf[:n], 2 * row + 1)):
        x = x.view(shape).detach().requires_grad_()
        kernels.reset_launches()
        with mock.patch.object(layers, "draw_seed", lambda _: seed), \
                mock.patch.object(layers, "_LAUNCH_ELEMENTS", launch), \
                sharded(Shard(None, row0, None)), row_sharded(shard):
            y = dropout_call(kind, x, rate, axis)
            (gx,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dropout"] == 2
        xw = x.detach().requires_grad_()
        want = torch.where(mask, xw / keep, torch.zeros_like(xw))
        (gw,) = torch.autograd.grad(want, xw, g)
        _same_bits(y, want)
        _same_bits(gx, gw)
        _same_bits(layers.dropout_ref(x.detach(), keep, *layout), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_keep_edge_and_non_finite_on_card(dtype):
    """2²⁶ elements at rate 0.1: the draws whose uniform equals float(keep)
    (hash >> 8 = 15,099,494, dropped by the fp32 compare) occur and match
    the formula; NaN and inf in x give 0 where dropped, and NaN and inf
    where kept, forward and backward."""
    _need_card()
    seed, keep, shape = 0x5EED0001, 1.0 - 0.1, (64, 1024, 1024)
    edge = hash_u32(torch.arange(math.prod(shape), device="cuda")
                    + ((seed * 0x9E3779B9) & 0xFFFFFFFF)) >> 8
    assert int((edge == 15099494).sum()) > 0
    del edge
    mask = formula_mask("element", shape, seed, keep, 0, None, 1, "cuda")
    x = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to("cuda", dtype)
    x.view(-1)[::1000] = float("nan")
    x.view(-1)[1::1000] = float("inf")
    x.view(-1)[2::1000] = -float("inf")
    g = x.flip(0).clone()
    x.requires_grad_()
    with mock.patch.object(layers, "draw_seed", lambda _: seed):
        y = fast_dropout(x, 0.1, True, None)
    (gx,) = torch.autograd.grad(y, x, g)
    xw = x.detach().requires_grad_()
    want = torch.where(mask, xw / keep, torch.zeros_like(xw))
    (gw,) = torch.autograd.grad(want, xw, g)
    _same_bits(y, want)
    _same_bits(gx, gw)
    assert not y[~mask].any() and not gx[~mask].any()
    assert y[mask].isnan().any() and y[mask].isinf().any()


# augmentation, card against CPU, images before normalisation (as
# chip_smoke.py holds it): only where the noise's floor moved a level
AUG_FLOOR_SHARE = 1e-3
AUG_FLOOR_STEP = 1.25


@pytest.mark.gpu
def test_augmentation_on_card_matches_cpu():
    """``augment_raw`` on the card against the CPU with the same uint8 inputs
    and the parameters drawn on the card: masks equal, images equal but where
    the noise's log and cos round apart and move its floor by one level."""
    from mdvit_tpu_torch.data.augment import augment_batch, augment_raw, sample_aug_params
    from mdvit_tpu_torch.data.datasets import synthetic_domain_arrays

    _need_card()
    data = synthetic_domain_arrays("DMF", 64, 8, 0)["train"]
    imgs = torch.from_numpy(data.images).float()
    msks = torch.from_numpy(data.masks).float()
    gen = torch.Generator(device="cuda").manual_seed(4)
    for _ in range(3):
        params = sample_aug_params(gen, 8, "cuda")
        assert all(v.is_cuda for v in params.values())
        got_x, got_m = augment_raw(imgs.cuda(), msks.cuda(), params)
        want_x, want_m = augment_raw(imgs, msks, {k: v.cpu() for k, v in params.items()})
        assert torch.equal(got_m.cpu(), want_m)
        diff = (got_x.cpu() - want_x).abs()
        assert int((diff > 0).sum()) <= AUG_FLOOR_SHARE * diff.numel()
        assert diff.max().item() <= AUG_FLOOR_STEP
    x, y = augment_batch(gen, imgs.cuda(), msks.cuda())
    assert x.is_cuda and torch.isfinite(x).all() and y.shape == (8, 64, 64, 1)


@pytest.mark.gpu
def test_trainer_debug_run_on_card_launches_all_kernels(tmp_path):
    """``python -m mdvit_tpu_torch.cli --synthetic --debug`` on the card
    (full widths, one block a stage, img 64, bf16): one train step, one eval
    batch a domain, test(); every kernel launched, test_results.csv with the
    Total row."""
    import csv

    from mdvit_tpu_torch import cli

    _need_card()
    cfg = tmp_path / "card.yml"
    cfg.write_text(
        "data: {img_size: 64, synthetic_sizes: {isic2018: [8, 3], PH2: [8, 3], "
        "DMF: [8, 3], SKD: [8, 3]}}\n"
        "train: {batch_size: 2, num_epochs: 1}\n"
        "model_kwargs: {num_layers: [1, 1, 1, 1]}\n")
    kernels.reset_launches()
    tr = cli.main(["--exp_name", "card", "--model", "MDViT", "--synthetic", "--debug",
                   "--config_yml", str(cfg), "--exp_dir", str(tmp_path / "exp")])
    torch.cuda.synchronize()
    assert tr.device.type == "cuda" and next(tr.model.parameters()).is_cuda
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    with open(tmp_path / "exp" / "test_results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["Name"] for r in rows][-1] == "Total" and len(rows) == 5
    assert all(np.isfinite(float(r[k])) for r in rows for k in ("loss", "Di_score", "IOU"))


def _op_inputs(name: str, c: int, ch: int, dtype) -> tuple:
    """A stage's op arguments (B=2, 16×16 grid): q, k, v slices of one
    projection, leaves needing grad for the forward ops; dropout's x and
    counter layout."""
    gen = torch.Generator().manual_seed(c)
    bwd = name.endswith("_bwd")

    def t(*shape, std=1.0, grad=False):
        a = (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)
        return a.requires_grad_(grad and not bwd)

    kind = name.removesuffix("_bwd")
    if kind == "dropout":  # an element mask of (2, 16, 16, C)
        row = 16 * 16 * c
        return (t(2, 16, 16, c, grad=True), 0.9, 0x2545F491, row, row, row)
    if kind == "factorized_attention":
        qkv = t(2, 256, 3 * c, grad=True)
        args = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])
        return args + ((t(2, 256, c),) if bwd else ()) + (ch, ch ** -0.5)
    if kind == "cpe_conv":
        x, w = t(2, 16, 16, c, grad=True), t(3, 3, c, std=0.5, grad=True)
        return (x, w, t(2, 16, 16, c)) if bwd else (x, w, t(c, std=0.1, grad=True))
    qkv = t(2, 16, 16, 3 * c, grad=True)
    args = (qkv[..., :c], qkv[..., 2 * c:], t(7, 7, c, std=0.2, grad=True),
            t(c, std=0.1, grad=True))
    return args + (t(2, 16, 16, c),) if bwd else args


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", OPS)
def test_opcheck_on_card(name, dtype):
    """``torch.library.opcheck`` of each op on CUDA tensors at stage 2's
    width (C = 320, ch = 40): schema, fake against the kernel, autograd
    registration, the op under ``aot_autograd``."""
    _need_card()
    with no_tf32():
        torch.library.opcheck(getattr(torch.ops.mdvit, name).default,
                              _op_inputs(name, 320, 40, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_forward_is_the_live_forward_on_card(dtype, tmp_path):
    """The full-width MDViT at 256² (B = 2, random weights): the program
    ``mdvit_tpu_torch.export`` saves, loaded, gives the live forward's bits,
    through 16 launches of each forward kernel."""
    from mdvit_tpu_torch import export
    from mdvit_tpu_torch.models.registry import build_mdvit
    from mdvit_tpu_torch.predict import make_forward

    _need_card()
    model = build_mdvit(img_size=256, num_domains=4, dtype=dtype, device="cuda", seed=0)
    path = str(tmp_path / "mdvit.pt2")
    torch.export.save(export.export_serving(model, 2, 256, 4), path)
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (2, 256, 256, 3), generator=gen).float().cuda()
    oh = torch.eye(4, device="cuda")[[1, 3]]
    program = export.load(path)
    kernels.reset_launches()
    got = export.run(program, x, oh)
    torch.cuda.synchronize()
    assert _counts(FORWARD) == {n: 16 for n in FORWARD}
    assert _counts(BACKWARD) == {n: 0 for n in BACKWARD}
    assert torch.equal(got, make_forward(model)(x, oh))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_repeats_its_bits_on_card(dtype):
    """Two MKD steps of MDViT at full width, one block a stage, 64²
    (dropout and augmentation on) from one state give the same losses,
    gradients, parameters and BN stats, bit for bit
    (``device.deterministic``)."""
    from mdvit_tpu_torch.models.registry import build_mdvit
    from mdvit_tpu_torch.train.optim import build_optimizer
    from mdvit_tpu_torch.train.steps import make_train_step

    _need_card()
    rs = np.random.RandomState(5)
    imgs = [torch.from_numpy(rs.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)).cuda()
            for _ in range(4)]
    masks = [torch.from_numpy(rs.randint(0, 2, (3, 64, 64)).astype(np.uint8)).cuda()
             for _ in range(4)]
    runs = []
    for _ in range(2):
        model = build_mdvit(img_size=64, device="cuda", seed=1, dtype=dtype,
                            num_layers=(1, 1, 1, 1))
        opt, sched = build_optimizer(model, steps_per_epoch=2)
        metrics = make_train_step(model, opt, sched, 4)(
            imgs, masks, torch.tensor([[0, 2]] * 4, device="cuda"))
        runs.append((metrics, [p.grad for p in model.parameters()], model.state_dict()))
    (m1, g1, s1), (m2, g2, s2) = runs
    assert all(torch.equal(v, m2[k]) for k, v in m1.items())
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(torch.equal(v, s2[k]) for k, v in s1.items())


@pytest.mark.gpu
@pytest.mark.parametrize("name,img", [("TransFuse_S", 64), ("UTNet", 128), ("SwinUNETR", 64),
                                      ("SwinUnet", 64)])
def test_zoo_step_repeats_its_bits_on_card(name, img):
    """Two steps of a comparator at its full widths (its own dropout, no
    augmentation) from one state give the same losses, gradients,
    parameters and BN stats, bit for bit, and launch none of MDViT's
    kernels (their dropout's aside): the max-pools', ``table[index]``'s and
    the transposed conv's backwards take deterministic paths under
    ``device.deterministic``."""
    from mdvit_tpu_torch.models.registry import build_model
    from mdvit_tpu_torch.train.optim import build_optimizer
    from mdvit_tpu_torch.train.steps import make_train_step

    _need_card()
    rs = np.random.RandomState(6)
    imgs = [torch.from_numpy(rs.randint(0, 256, (3, img, img, 3)).astype(np.uint8)).cuda()
            for _ in range(4)]
    masks = [torch.from_numpy(rs.randint(0, 2, (3, img, img)).astype(np.uint8)).cuda()
             for _ in range(4)]
    runs = []
    kernels.reset_launches()
    for _ in range(2):
        model = build_model(name, img_size=img, device="cuda", seed=1)
        opt, sched = build_optimizer(model, steps_per_epoch=2)
        metrics = make_train_step(model, opt, sched, 4, mkd=False, device_augment=False)(
            imgs, masks, torch.tensor([[0, 2]] * 4, device="cuda"))
        runs.append((metrics, [p.grad for p in model.parameters()], model.state_dict()))
    (m1, g1, s1), (m2, g2, s2) = runs
    assert all(torch.equal(v, m2[k]) for k, v in m1.items())
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(torch.equal(v, s2[k]) for k, v in s1.items())
    assert not any(_counts(FORWARD + BACKWARD).values())


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst,c", [((8, 8), (64, 64), 64), ((64, 64), (256, 256), 1)])
def test_resize_backward_repeats_its_bits_on_card(src, dst, c):
    """The separable resize's backward gives the same bits twice (the
    ``F.interpolate`` backward it replaced accumulates with atomics), and
    its forward equals ``F.interpolate``'s to 1e-6 of the largest value."""
    import torch.nn.functional as F

    from mdvit_tpu_torch.ops.resize import resize_bilinear

    _need_card()
    gen = torch.Generator().manual_seed(c)
    x = torch.randn(16, *src, c, generator=gen).cuda().requires_grad_()
    g = torch.randn(16, *dst, c, generator=gen).cuda()
    with no_tf32():
        y = resize_bilinear(x, dst)
        grads = [torch.autograd.grad(resize_bilinear(x, dst), x, g)[0] for _ in range(2)]
        ref = F.interpolate(x.detach().permute(0, 3, 1, 2), size=dst, mode="bilinear",
                            align_corners=False).permute(0, 2, 3, 1)
    assert torch.equal(grads[0], grads[1])
    assert (y - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPS)
def test_ops_on_no_rows_launch_nothing_on_card(name):
    """A batch of 0 rows (a data-parallel rank's empty domain group): each op
    returns its empty outputs (zero weight gradients) without a launch."""
    _need_card()
    args = _op_inputs(name, 64, 8, torch.float32)
    # the batched arguments lead with _op_inputs' B = 2; w and b do not
    args = tuple(a[:0] if isinstance(a, torch.Tensor) and a.dim() >= 3 and a.shape[0] == 2
                 else a for a in args)
    kernels.reset_launches()
    out = getattr(torch.ops.mdvit, name)(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == 0
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.shape[0] == 0 or not t.any()


# ---------------------------------------------------------------- context parallelism

# (B, H·W, C, ch) split in row halves: the MDViT stages at 256², and BASE's
# four grids at 512², B=2, whose halves a rank of the 2-rank CP step sends
# A and A′ (up to 64 chunks folded a (b, h))
CP_STAGES = [(4, 4096, 64, 8), (4, 1024, 128, 16), (4, 256, 320, 40), (4, 64, 512, 64),
             (2, 16384, 64, 8), (2, 4096, 128, 16), (2, 1024, 320, 40), (2, 256, 512, 64)]


def _split_attention(q, k, v, g, ch):
    """A and A′ as two ranks run them: each half's partials, the workspaces
    concatenated a (b, h) in rank order (the all-gather), each half's apply."""
    ops = torch.ops.mdvit
    scale = ch ** -0.5
    n = q.shape[1]
    rows = [slice(0, n // 2), slice(n // 2, n)]
    ws = torch.cat([ops.factorized_attention_partials(k[:, r], v[:, r], ch) for r in rows], 1)
    out = torch.cat([ops.factorized_attention_apply(q[:, r], ws, ch, scale) for r in rows], 1)
    wsb = torch.cat([ops.factorized_attention_bwd_partials(q[:, r], k[:, r], v[:, r], g[:, r], ch)
                     for r in rows], 1)
    grads = [torch.cat(d, 1) for d in zip(*[
        ops.factorized_attention_bwd_apply(k[:, r], v[:, r], g[:, r], wsb, ch, scale)
        for r in rows])]
    return [out, *grads]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c,ch", CP_STAGES)
def test_attention_gathered_partials_match_single_call_on_card(b, n, c, ch, dtype,
                                                               record_property):
    """The split ops on row halves (gathered partials) against the single
    call (fp32: within 1e-6 of the largest value; bf16: a rounding step) and
    against the plain versions (fp32: within 1e-5, the bound of every kernel
    against its plain version, ``chip_smoke.py``'s ``TOL``: the plain einsums
    sum dk's and dv's N products in another order); the apply counts one A
    (A′) launch a call. The errors go to the JUnit report."""
    _need_card()
    gen = torch.Generator().manual_seed(n + c)
    q, k, v, g = (torch.randn(b, n, c, generator=gen).mul(s).cuda().to(dtype)
                  for s in (1.0, 3.0, 1.0, 1.0))
    scale = ch ** -0.5
    kernels.reset_launches()
    got = _split_attention(q, k, v, g, ch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["factorized_attention"] == 2
    assert kernels.LAUNCHES["factorized_attention_bwd"] == 2
    single = [fa.factorized_attention(q, k, v, ch, scale),
              *torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ch, scale)]
    plain = [fa.factorized_attention_ref(q, k, v, ch, scale),
             *fa.factorized_attention_bwd_ref(q, k, v, g, ch, scale)]
    def rel(a, want):  # relative to the output's largest value
        return ((a.float() - want.float()).abs().max() / want.float().abs().max()).item()

    vs_single = [rel(a, s) for a, s in zip(got, single)]
    vs_plain = [rel(a, p) for a, p in zip(got, plain)]
    record_property("vs_single_out_dq_dk_dv", vs_single)
    record_property("vs_plain_out_dq_dk_dv", vs_plain)
    assert max(vs_single) <= (1e-6 if dtype == torch.float32 else 2 ** -7)
    assert max(vs_plain) <= (1e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,ch,tokens", [(7680 + 6720, 64, 8, (7680, 6720)),
                                           (480 + 420, 320, 40, (480, 420)),
                                           (430, 96, 12, (300, 129, 1))])
def test_attention_padded_partials_fold_to_nothing_on_card(n, c, ch, tokens, dtype):
    """Blocks of unequal token counts (BASE's 120² and 30² grids at 480²
    split 8 : 7, and a one-token block): each block's workspace padded to the
    most chunks with empty partials, last or first in its block, so empty
    partials sit inside the fold; both applies give the bits they give on
    the unpadded workspaces (an empty partial adds exact zeros)."""
    _need_card()
    gen = torch.Generator().manual_seed(n + c)
    q, k, v, g = (torch.randn(2, n, c, generator=gen).mul(s).cuda().to(dtype)
                  for s in (1.0, 3.0, 1.0, 1.0))
    scale = ch ** -0.5
    cuts = np.cumsum((0,) + tokens)
    rows = [slice(int(cuts[i]), int(cuts[i + 1])) for i in range(len(tokens))]
    ops = torch.ops.mdvit
    fwd = [ops.factorized_attention_partials(k[:, r], v[:, r], ch) for r in rows]
    bwd = [ops.factorized_attention_bwd_partials(q[:, r], k[:, r], v[:, r], g[:, r], ch)
           for r in rows]
    assert len({w.shape[1] for w in fwd}) > 1 or len({w.shape[1] for w in bwd}) > 1
    outs = {}
    for where in ("none", "last", "first"):
        ws = torch_cp.padded_workspace(fwd, tokens, ch, False, where)
        wsb = torch_cp.padded_workspace(bwd, tokens, ch, True, where)
        outs[where] = [ops.factorized_attention_apply(q[:, r], ws, ch, scale) for r in rows] + [
            d for r in rows for d in ops.factorized_attention_bwd_apply(k[:, r], v[:, r], g[:, r],
                                                                        wsb, ch, scale)]
    for where in ("last", "first"):
        for got, want in zip(outs[where], outs["none"]):
            assert bool(torch.isfinite(got.float()).all())
            assert torch.equal(got, want), where


@pytest.mark.gpu
def test_split_chunking_matches_library_on_card():
    """The wrapper's mirror of the chunking (``chunk_rows``,
    ``partial_floats``) is the library's for every head width."""
    _need_card()
    lib = kernels.library("factorized_attention")
    for ch in range(1, fa.MAX_CH + 1):
        for grad in (0, 1):
            assert lib.mdvit_factorized_attention_chunk_rows(ch, grad) == fa.chunk_rows(ch, grad)
            assert lib.mdvit_factorized_attention_partial(ch, grad) == fa.partial_floats(ch, grad)
    assert lib.mdvit_factorized_attention_partial(65, 0) == -1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ch", STAGE_C_CH)
def test_dwconv_on_halo_rows_matches_full_grid_on_card(c, ch, dtype):
    """B and C on a rank's rows plus its k//2 halo rows (CRPE's q zero-padded),
    middle rows kept, against the full grid; B′ and C′ with the halo rows'
    gradients added back into their owners' rows, and dw, db summed over the
    two halves."""
    _need_card()
    h = {64: 64, 128: 32, 320: 16, 512: 8}[c]
    h2 = h // 2
    gen = torch.Generator().manual_seed(c)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda().to(dtype)

    x, q, v, g = (rnd(2, h, h, c) for _ in range(4))
    wc, bc, wr, br = rnd(3, 3, c, std=0.2), rnd(c, std=0.1), rnd(7, 7, c, std=0.1), rnd(c, std=0.1)

    def halo(t, r, p):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, p, p))[:, r * h2:r * h2 + h2 + 2 * p]

    def own(t, r, p):  # rank r's rows, zero-padded by p rows (q, g)
        return torch.nn.functional.pad(t[:, r * h2:(r + 1) * h2], (0, 0, 0, 0, p, p))

    def add_back(parts, p):
        full = parts[0].new_zeros((2, h + 2 * p, h, c))
        for r, t in enumerate(parts):
            full[:, r * h2:r * h2 + h2 + 2 * p] += t
        return full[:, p:p + h]

    cpe = torch.cat([dwconv.cpe_conv(halo(x, r, 1), wc, bc)[:, 1:-1] for r in (0, 1)], 1)
    crpe = torch.cat([dwconv.crpe_conv(own(q, r, 3), halo(v, r, 3), wr, br)[:, 3:-3]
                      for r in (0, 1)], 1)
    torch.testing.assert_close(cpe, dwconv.cpe_conv(x, wc, bc), **GPU_TOL[dtype])
    torch.testing.assert_close(crpe, dwconv.crpe_conv(q, v, wr, br), **GPU_TOL[dtype])
    cb = [torch.ops.mdvit.cpe_conv_bwd(halo(x, r, 1), wc, own(g, r, 1)) for r in (0, 1)]
    rb = [torch.ops.mdvit.crpe_conv_bwd(own(q, r, 3), halo(v, r, 3), wr, br, own(g, r, 3))
          for r in (0, 1)]
    dx, dwb_c = torch.ops.mdvit.cpe_conv_bwd(x, wc, g)
    dq, dv, dwb_r = torch.ops.mdvit.crpe_conv_bwd(q, v, wr, br, g)
    torch.testing.assert_close(add_back([t[0] for t in cb], 1), dx, **GRAD_TOL[dtype])
    torch.testing.assert_close(torch.cat([t[0][:, 3:-3] for t in rb], 1), dq, **GRAD_TOL[dtype])
    torch.testing.assert_close(add_back([t[1] for t in rb], 3), dv, **GRAD_TOL[dtype])
    for got, want in ((cb[0][1] + cb[1][1], dwb_c), (rb[0][2] + rb[1][2], dwb_r)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
