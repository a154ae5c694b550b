"""The port's kernel functions against the JAX package's XLA twins.

``factorized_attention_ref``, ``cpe_conv_ref`` and ``crpe_conv_ref`` (the
plain versions beside the CUDA kernels) against ``factorized_attention_xla``,
``cpe_conv_xla`` and ``crpe_conv_xla`` at every MDViT stage's (C, ch), fp32,
inputs from a seeded numpy RandomState. On the CPU each kernel wrapper runs
its plain version and counts no launch. The factorized-attention forward's
two-launch algorithm (chunk partials, a fixed-order fold, then scale·q·T) is
written out in plain torch and held against the XLA twin at ragged N. The
CUDA kernels themselves are held against the plain versions in
``test_torch_kernels_gpu.py``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.ops.pallas_attention import factorized_attention_xla
from mdvit_tpu.ops.pallas_dwconv import cpe_conv_xla, crpe_conv_xla
from mdvit_tpu_torch.device import no_tf32
from mdvit_tpu_torch.models.blocks import ConvRelPosEnc
from mdvit_tpu_torch.ops import dwconv, kernels
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops.layers import fast_dropout
from tests.test_torch_kernels_gpu import ATTN_FWD_CHUNK_ROWS, attn_bucket
from tests.test_torch_train_kernels import CHUNKED_CASES

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_C_CH = [(64, 8), (128, 16), (320, 40), (512, 64)]
# fp32 sums taken in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rs, b, n, c):
    """q, k, v as the model makes them: slices of one (B, N, 3C) tensor."""
    qkv = torch.from_numpy(rs.standard_normal((b, n, 3 * c)).astype(np.float32))
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


@pytest.mark.parametrize("c,ch", STAGE_C_CH)
def test_factorized_attention_ref_matches_xla(c, ch):
    rs = np.random.RandomState(c)
    q, k, v = _qkv(rs, 2, 64, c)
    scale = ch ** -0.5
    want = np.asarray(factorized_attention_xla(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), ch, scale))
    np.testing.assert_allclose(fa.factorized_attention_ref(q, k, v, ch, scale).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(fa.factorized_attention(q, k, v, ch, scale).numpy(),
                               want, **TOL)


# (C, ch, N): the classifiers' head widths off the 4-aligned widths (MPViT's
# 22, 27, 46; CoaT's 19, 27), at N = H·W + 1 (CoaT's cls row) and N = H·W
CLASSIFIER_C_CH_N = [(152, 19, 50), (152, 19, 197), (176, 22, 196), (216, 27, 50),
                     (216, 27, 785), (368, 46, 197)]


@pytest.mark.parametrize("c,ch,n", CLASSIFIER_C_CH_N, ids=lambda x: str(x))
def test_factorized_attention_ref_matches_xla_at_classifier_widths(c, ch, n):
    """The plain forward and backward against the XLA twin and its vjp, with
    q, k, v slices of one (B, N, 3C) tensor."""
    rs = np.random.RandomState(c + n)
    q, k, v = _qkv(rs, 2, n, c)
    g = rs.standard_normal((2, n, c)).astype(np.float32)
    scale = ch ** -0.5
    out, vjp = jax.vjp(lambda q, k, v: factorized_attention_xla(q, k, v, ch, scale),
                       *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(fa.factorized_attention_ref(q, k, v, ch, scale).numpy(),
                               np.asarray(out), **TOL)
    got = fa.factorized_attention_bwd_ref(q, k, v, torch.from_numpy(g), ch, scale)
    for a, e in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL)


def _chunked_attention_fwd(q, k, v, ch, scale):
    """The CUDA forward's two launches in plain torch, fp32 (the split plain
    versions): the partials of k and v per chunk of ``ATTN_FWD_CHUNK_ROWS``
    tokens of ch's width bucket, the fold over the chunks in their order,
    then out = scale·q·T."""
    ws = fa.factorized_attention_partials_ref(k, v, ch)
    return fa.factorized_attention_apply_ref(q, ws, ch, scale)


@pytest.mark.parametrize("c,ch,n", CHUNKED_CASES, ids=lambda x: str(x))
def test_chunked_attention_fwd_matches_xla(c, ch, n):
    """k is scaled ×20, so each head's column maxima fall in different chunks
    and exp(m_s − M) spans many decades, and one column's maximum sits in the
    last, ragged chunk. fp32 against JAX at ``highest``: sums over up to 1000
    tokens in another order, so the output is held relative to its largest
    value."""
    rs = np.random.RandomState(n + c + 1)
    q, k, v = (rs.standard_normal((2, n, c)).astype(np.float32) for _ in range(3))
    k *= 20.0
    k[:, -1, 3] = k[:, :, 3].max() + 5.0
    rows = ATTN_FWD_CHUNK_ROWS[attn_bucket(ch)]
    assert len(np.unique(k.argmax(axis=1) // rows)) > 1 or n <= rows
    scale = ch ** -0.5
    want = np.asarray(factorized_attention_xla(*map(jnp.asarray, (q, k, v)), ch, scale))
    got = _chunked_attention_fwd(*map(torch.from_numpy, (q, k, v)), ch, scale).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


# (B, H, W, C): the stage widths at 8×8, then ragged shapes that cut the tiled
# kernels' 8×16 tiles and 32-channel slices unevenly, and C = 12
CPE_CASES = [pytest.param(2, 8, 8, c, id=str(c)) for c, _ in STAGE_C_CH] + [
    pytest.param(2, 37, 23, 40, id="2x37x23x40"), pytest.param(3, 5, 9, 24, id="3x5x9x24"),
    pytest.param(1, 64, 64, 64, id="1x64x64x64"), pytest.param(2, 9, 7, 12, id="2x9x7x12")]


@pytest.mark.parametrize("bsz,h,wd,c", CPE_CASES)
def test_cpe_conv_ref_matches_xla(bsz, h, wd, c):
    rs = np.random.RandomState(c + 1 + h - 8)
    x = rs.standard_normal((bsz, h, wd, c)).astype(np.float32)
    w = (rs.standard_normal((3, 3, c)) * (2 / 9) ** 0.5).astype(np.float32)
    b = (0.1 * rs.standard_normal(c)).astype(np.float32)
    want = np.asarray(cpe_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    np.testing.assert_allclose(dwconv.cpe_conv_ref(tx, tw, tb).numpy(), want, **TOL)
    np.testing.assert_allclose(dwconv.cpe_conv(tx, tw, tb).numpy(), want, **TOL)


# (B, H, W, C, ch): the stage widths at 8×8, then ragged shapes as CPE's
CRPE_CASES = [pytest.param(2, 8, 8, c, ch, id=f"{c}-{ch}") for c, ch in STAGE_C_CH] + [
    pytest.param(2, 37, 23, 40, 5, id="2x37x23x40"),
    pytest.param(3, 5, 9, 24, 3, id="3x5x9x24"),
    pytest.param(1, 64, 64, 64, 8, id="1x64x64x64")]


@pytest.mark.parametrize("bsz,h,wd,c,ch", CRPE_CASES)
def test_crpe_conv_ref_matches_xla(bsz, h, wd, c, ch):
    """CRPE with the 3/5/7 windows over 2/3/3 heads, each assembled into one
    7×7 kernel: the port's ``ConvRelPosEnc.kernel`` against the JAX
    package's zero-embedding (blocks.py ConvRelPosEnc)."""
    rs = np.random.RandomState(c + 2 + h - 8)
    crpe = ConvRelPosEnc(ch, 8)
    jax_w, jax_b = [], []
    with torch.no_grad():
        for conv, (k, heads) in zip(crpe.conv_list, [(3, 2), (5, 3), (7, 3)]):
            wk = (rs.standard_normal((k, k, 1, heads * ch)) * (2 / k ** 2) ** 0.5
                  ).astype(np.float32)
            bk = (0.1 * rs.standard_normal(heads * ch)).astype(np.float32)
            conv.weight.copy_(torch.from_numpy(wk.transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(bk))
            p = (7 - k) // 2
            jax_w.append(np.pad(wk, ((p, p), (p, p), (0, 0), (0, 0))))
            jax_b.append(bk)
    w7 = np.concatenate(jax_w, axis=-1)[:, :, 0]
    b7 = np.concatenate(jax_b)
    qkv = rs.standard_normal((bsz, h, wd, 3 * c)).astype(np.float32)
    q, v = qkv[..., :c], qkv[..., 2 * c:]
    want = np.asarray(crpe_conv_xla(jnp.asarray(q), jnp.asarray(v),
                                    jnp.asarray(w7), jnp.asarray(b7)))
    tw, tb = crpe.kernel()
    np.testing.assert_array_equal(tw.detach().numpy(), w7)
    tqkv = torch.from_numpy(qkv)
    tq, tv = tqkv[..., :c], tqkv[..., 2 * c:]
    with torch.no_grad():
        np.testing.assert_allclose(dwconv.crpe_conv_ref(tq, tv, tw, tb).numpy(),
                                   want, **TOL)
        got = crpe(tq.flatten(1, 2), tv.flatten(1, 2), (h, wd))
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, **TOL)


@pytest.mark.parametrize("dtype,c,offset,want", [
    (torch.float32, 64, 0, 16), (torch.float32, 6, 0, 8), (torch.float32, 5, 0, 4),
    (torch.bfloat16, 64, 0, 16), (torch.bfloat16, 12, 0, 8), (torch.bfloat16, 6, 0, 4),
    (torch.bfloat16, 5, 0, 2), (torch.float32, 64, 1, 4)])
def test_crpe_copy_width_from_alignment(dtype, c, offset, want):
    """The tiled kernels copy the widest of 16/8/4/2 bytes that C, the
    strides of their views and the pointers allow: CRPE's q and v as slices
    of one (B, H, W, 3C) projection; CPE's x contiguous and as a slice of a
    wider tensor, with its contiguous output (and g, dx backward).
    ``offset`` shifts the projection, and the contiguous x, by one element."""
    n = 2 * 5 * 7 * 3 * c
    flat = torch.zeros(n + 1, dtype=dtype)
    qkv = flat[offset:offset + n].view(2, 5, 7, 3 * c)
    assert dwconv._copy_bytes(qkv[..., :c], qkv[..., 2 * c:]) == want
    out = torch.zeros(2, 5, 7, c, dtype=dtype)
    x = flat[offset:offset + n // 3].view(2, 5, 7, c)
    assert dwconv._copy_bytes(x, out) == want
    assert dwconv._copy_bytes(qkv[..., c:2 * c], out, out.clone()) == want


def test_crpe_weight_tiles():
    """CPE's and CRPE's backwards share one tile counter: one partial dw/db
    row per 8×16 tile (8×8 for images at most 8 wide), whatever K."""
    assert kernels.dwconv_weight_tiles(16, 64, 64) == 16 * 8 * 4
    assert kernels.dwconv_weight_tiles(16, 8, 8) == 16
    assert kernels.dwconv_weight_tiles(2, 37, 23) == 2 * 5 * 2
    assert kernels.dwconv_weight_tiles(3, 5, 9) == 3 * 1 * 1
    assert kernels.dwconv_weight_tiles(2, 9, 7) == 2 * 2 * 1
    assert kernels.dwconv_weight_tiles(1, 8, 9) == 1 * 1 * 1


def test_cpu_tensors_count_no_launch():
    rs = np.random.RandomState(5)
    kernels.reset_launches()
    q, k, v = _qkv(rs, 1, 16, 64)
    fa.factorized_attention(q, k, v, 8, 8 ** -0.5)
    g = q.unflatten(1, (4, 4))
    dwconv.cpe_conv(g, torch.zeros(3, 3, 64), torch.zeros(64))
    dwconv.crpe_conv(g, v.unflatten(1, (4, 4)), torch.zeros(7, 7, 64),
                     torch.zeros(64))
    fast_dropout(g, 0.1, True, torch.Generator().manual_seed(0))
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}


def test_package_imports_no_jax():
    """Every module of the port imports without JAX, flax or the JAX
    package; the training CLI, the export and the k-fold tools also without
    pandas and PyYAML."""
    pkg = os.path.join(REPO, "mdvit_tpu_torch")
    modules = sorted(
        "mdvit_tpu_torch." + os.path.relpath(os.path.join(root, f), pkg)[:-3]
        .replace(os.sep, ".").removesuffix(".__init__")
        for root, _, files in os.walk(pkg) for f in files if f.endswith(".py"))
    assert "mdvit_tpu_torch.train.trainer" in modules and len(modules) > 25
    assert {"mdvit_tpu_torch.parallel.context", "mdvit_tpu_torch.train.losses_extra",
            "mdvit_tpu_torch.train.flat_optim"} <= set(modules)
    code = ("import importlib, sys; import mdvit_tpu_torch.cli, mdvit_tpu_torch.export, "
            "mdvit_tpu_torch.kfold_aggregate, mdvit_tpu_torch.summarize_run; "
            "third = [m for m in sys.modules if m.split('.')[0] in ('pandas', 'yaml')]; "
            "assert not third, third; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'flax' or m == 'mdvit_tpu' or m.startswith('mdvit_tpu.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_parse_ptxas_report():
    log = ("ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooPf\n"
           "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 40 registers, 8448 bytes smem, 380 bytes cmem[0]\n")
    assert kernels.parse_ptxas(log) == [{
        "kernel": "_Z3fooPf", "registers": 40, "smem_bytes": 8448,
        "spill_stores": 4, "spill_loads": 8}]


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def test_no_tf32_turns_tf32_off_and_restores_the_flags():
    saved = _tf32_flags()
    try:
        for conv, matmul in ((True, "high"), (False, "medium"), (True, "highest")):
            torch.backends.cudnn.allow_tf32 = conv
            torch.set_float32_matmul_precision(matmul)
            before = _tf32_flags()
            with no_tf32():
                assert _tf32_flags() == (False, False, "highest")
            assert _tf32_flags() == before
        with pytest.raises(KeyError), no_tf32():
            raise KeyError("an error inside")
        assert _tf32_flags() == before
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[2])


def test_entry_points_run_without_tf32():
    """``make_forward``'s forward and ``make_train_step``'s step run the model
    with TF32 off while the caller's flags say on, and leave them on."""
    from mdvit_tpu_torch.models.registry import build_mdvit
    from mdvit_tpu_torch.predict import make_forward
    from mdvit_tpu_torch.train.optim import build_optimizer
    from mdvit_tpu_torch.train.steps import make_train_step

    saved = _tf32_flags()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        model = build_mdvit(img_size=32, device="cpu", embed_dims=(16, 32, 40, 64),
                            num_layers=(1, 1, 1, 1))
        seen = []
        model.register_forward_pre_hook(lambda mod, args: seen.append(_tf32_flags()))
        rs = np.random.RandomState(4)
        make_forward(model)(torch.from_numpy(rs.uniform(0, 255, (2, 32, 32, 3))).float(),
                            torch.eye(4)[[0, 3]])
        opt, sched = build_optimizer(model, steps_per_epoch=2)
        imgs = [torch.from_numpy(rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8))
                for _ in range(4)]
        masks = [torch.from_numpy(rs.randint(0, 2, (2, 32, 32)).astype(np.uint8))
                 for _ in range(4)]
        make_train_step(model, opt, sched, 4, device_augment=False)(
            imgs, masks, torch.tensor([[0, 1]] * 4))
        assert seen == [(False, False, "highest")] * 2
        assert _tf32_flags()[:2] == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[2])
