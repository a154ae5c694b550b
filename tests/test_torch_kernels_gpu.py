"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips inside the test when there is no
CUDA card. The file imports only torch, numpy and the port, so it runs on a
machine without JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""
import numpy as np
import pytest
import torch

from mdvit_tpu_torch.device import no_tf32
from mdvit_tpu_torch.ops import dwconv, kernels
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import dropout2d, drop_path, fast_dropout

torch.set_num_threads(2)

STAGE_C_CH = [(64, 8), (128, 16), (320, 40), (512, 64)]
FORWARD = ("factorized_attention", "cpe_conv", "crpe_conv")
BACKWARD = ("factorized_attention_bwd", "cpe_conv_bwd", "crpe_conv_bwd")


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
    q = torch.randn(1, 16, 48, device="cuda")  # ch = 12 has no kernel
    with pytest.raises(ValueError):
        fa.factorized_attention(q, q, q, 12, 1.0)
    with pytest.raises(TypeError):
        fa.factorized_attention(q.half(), q.half(), q.half(), 8, 1.0)


@pytest.mark.gpu
def test_model_forward_on_card_goes_through_the_kernels():
    """A small full-width MDViT on the card: one launch of each kernel per
    serial block, and the same logits as through the plain versions."""
    from unittest import mock

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
    assert _counts(BACKWARD) == {n: 0 for n in BACKWARD}
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


# token rows of a chunk of the factorized-attention kernels by head width, as
# ``AttnChunk<CH, kGrad>::kRows`` in factorized_attention.cu cuts them: the
# backward's, and the forward's (it stages two inputs, not four, and takes
# twice the rows at ch 64). The library sizes the workspace itself
# (``mdvit_factorized_attention_workspace``); these set the chunks of the
# plain-torch emulations in the CPU tests, and
# ``test_attention_workspace_matches_chunk_rows_on_card`` holds them to it.
ATTN_CHUNK_ROWS = {8: 256, 16: 128, 40: 64, 64: 32}
ATTN_FWD_CHUNK_ROWS = {8: 256, 16: 128, 40: 64, 64: 64}
# The factorized-attention kernels' chunked split, (B, N, C, ch, k scale): N
# ragged against the chunk rows (``ATTN_CHUNK_ROWS``, ``ATTN_FWD_CHUNK_ROWS``),
# k ×20 so that the column maxima fall in different
# chunks and one in the last, ragged chunk; and N = 4096 at ch 8 with B = 1
# (16 chunks)
ATTN_SPLIT_CASES = [(2, 257, 64, 8, 20.0), (2, 1000, 64, 8, 20.0), (2, 33, 128, 16, 20.0),
                    (2, 257, 128, 16, 20.0), (2, 1000, 320, 40, 20.0), (2, 33, 512, 64, 20.0),
                    (2, 1000, 512, 64, 20.0), (1, 4096, 64, 8, 1.0), (1, 4096, 64, 8, 20.0)]
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
    """The library's workspace floats per (batch element, head): ⌈N / rows⌉
    chunks of 2·ch + ch² (forward) or 2·ch + 2·ch² (backward), with the rows
    of ``ATTN_FWD_CHUNK_ROWS`` and ``ATTN_CHUNK_ROWS``; -1 for a head width
    the kernels are not built for."""
    _need_card()
    lib = kernels.library("factorized_attention")
    for grad, table in ((0, ATTN_FWD_CHUNK_ROWS), (1, ATTN_CHUNK_ROWS)):
        for ch, rows in table.items():
            for n in (1, 33, 64, 256, 257, 1000, 4096):
                want = -(-n // rows) * (2 * ch + (1 + grad) * ch * ch)
                assert lib.mdvit_factorized_attention_workspace(n, ch, grad) == want
        assert lib.mdvit_factorized_attention_workspace(64, 12, grad) == -1


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
    projection, leaves needing grad for the forward ops."""
    gen = torch.Generator().manual_seed(c)
    bwd = name.endswith("_bwd")

    def t(*shape, std=1.0, grad=False):
        a = (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)
        return a.requires_grad_(grad and not bwd)

    kind = name.removesuffix("_bwd")
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
@pytest.mark.parametrize("name", FORWARD + BACKWARD)
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
