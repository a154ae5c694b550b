"""Factorized attention ``scale · q_h · (softmaxₙ(k_h)ᵀ v_h)`` per head.

Counterpart of ``mdvit_tpu/ops/pallas_attention.py``. The kernel and its
backward are the ``torch.library`` custom ops ``mdvit::factorized_attention``
and ``mdvit::factorized_attention_bwd``: on a CUDA tensor each launches its
kernels of ``csrc/factorized_attention.cu``, on a CPU tensor it runs its
plain PyTorch version (``factorized_attention_ref``,
``factorized_attention_bwd_ref``), and under ``torch.export`` or a fake
tensor its fake gives the output's shape and dtype. All take the softmax
over the N tokens in fp32, accumulate in fp32 and round once to the input
dtype, as the Pallas kernels do.

The forward op's registered autograd (the Pallas kernel's ``custom_vjp``)
saves q, k, v and calls the backward op, which recomputes the softmax, so no
(B, N, C) softmax is kept for the backward. The backward op has no autograd
of its own: a double backward raises. Importing this module registers the
ops and builds nothing; the first CUDA call builds the kernels.

Context parallelism (``factorized_attention_cp``): each rank of a group
holds a block of the N tokens. The softmax over N and KᵀV are the only
couplings across tokens, and each launch pair already meets at a workspace
of per-chunk partials (m_s, l_s, T_s and, backward, D_s = Σ qᵀg), so each
direction is split into two ops, ``mdvit::factorized_attention_partials`` →
``…_apply`` and ``…_bwd_partials`` → ``…_bwd_apply``, with an all-gather
of the fp32 workspace between them: every rank's apply folds all ranks'
partials in rank order, so every rank forms the same T (and dT) bits. Ranks
may hold different numbers of tokens (uneven row blocks, CoaT's cls row on
rank 0): each pads its workspace to the most chunks any rank holds with
empty partials (m = −∞, zero sums), which the folds skip. The
plain versions (``*_partials_ref``, ``*_apply_ref``) keep the kernels'
workspace layout (``ATTN_CHUNK_ROWS``, ``attn_bucket``), so a kernel's
workspace can meet a plain apply and the other way round. One A call under
a group counts once in ``kernels.LAUNCHES``, at its apply (A′ likewise).
"""
from __future__ import annotations

import functools
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from mdvit_tpu_torch.ops import kernels
from mdvit_tpu_torch.parallel.mesh import collective, counted

# the widest head the kernels take: any ch from 1 to MAX_CH that divides C
# runs (MDViT's 8, 16, 40, 64 in instances of their own, every other ch in
# the next 4-multiple width bucket, its padded columns zero)
MAX_CH = 64


def _heads(t: torch.Tensor, ch: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.float().reshape(b, n, c // ch, ch)


def factorized_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             ch: int, scale: float) -> torch.Tensor:
    """Plain version: q, k, v (B, N, C) with C = heads·ch → (B, N, C)."""
    qf, kf, vf = (_heads(t, ch) for t in (q, k, v))
    ks = torch.softmax(kf, dim=1)
    ktv = torch.einsum("bnhk,bnhv->bhkv", ks, vf)
    out = torch.einsum("bnhk,bhkv->bnhv", qf, ktv)
    return (scale * out).reshape(q.shape).to(q.dtype)


def factorized_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 g: torch.Tensor, ch: int, scale: float
                                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward (``_bwd_kernel``): the softmax recomputed, then
    dq = scale·g·Tᵀ, dT = scale·qᵀg, dv = ks·dT and
    dk = ks ⊙ (v·dTᵀ − colsumₙ(ks ⊙ v·dTᵀ)), per head, T = ksᵀv."""
    qf, kf, vf, gf = (_heads(t, ch) for t in (q, k, v, g))
    ks = torch.softmax(kf, dim=1)
    t = torch.einsum("bnhk,bnhv->bhkv", ks, vf)
    dt = scale * torch.einsum("bnhk,bnhv->bhkv", qf, gf)
    dq = scale * torch.einsum("bnhv,bhkv->bnhk", gf, t)
    dv = torch.einsum("bnhk,bhkv->bnhv", ks, dt)
    dks = torch.einsum("bnhv,bhkv->bnhk", vf, dt)
    dk = ks * (dks - (ks * dks).sum(dim=1, keepdim=True))
    return tuple(d.reshape(q.shape).to(q.dtype) for d in (dq, dk, dv))


# head width buckets of the kernels (``dispatch_ch``): a ch runs in the
# narrowest bucket at least as wide, its columns past ch zero
ATTN_BUCKETS = (8, 12, 16, 20, 24, 28, 32, 36, 40, 48, 64)
# token rows of a chunk by bucket (``AttnChunk<CH, kGrad>::kRows``): the
# backward's, and the forward's (twice the rows at 64); the CUDA wrappers
# hold these to the library's own (``mdvit_factorized_attention_chunk_rows``)
ATTN_CHUNK_ROWS = {8: 256, 12: 192, 16: 128, 20: 128, 24: 96, 28: 80, 32: 64, 36: 64,
                   40: 64, 48: 48, 64: 32}
ATTN_FWD_CHUNK_ROWS = {**ATTN_CHUNK_ROWS, 64: 64}


def attn_bucket(ch: int) -> int:
    if not 1 <= ch <= MAX_CH:
        raise ValueError(f"factorized_attention: ch={ch} outside 1..{MAX_CH}")
    return next(b for b in ATTN_BUCKETS if b >= ch)


def chunk_rows(ch: int, grad: bool) -> int:
    return (ATTN_CHUNK_ROWS if grad else ATTN_FWD_CHUNK_ROWS)[attn_bucket(ch)]


def partial_floats(ch: int, grad: bool) -> int:
    """fp32 values of one (b, h, chunk) partial: m_s, l_s (W each), T_s
    (W×W) and, backward, D_s (W×W), W the bucket width."""
    w = attn_bucket(ch)
    return 2 * w + (2 if grad else 1) * w * w


def _chunked(t: torch.Tensor, ch: int, rows: int, fill: float) -> torch.Tensor:
    """(B, N, heads·ch) → (B, heads, S, rows, W) fp32: each head's columns
    zero-padded to the bucket width W, N cut into S chunks of ``rows``, the
    last chunk's missing rows ``fill``."""
    b, n, c = t.shape
    w, s = attn_bucket(ch), -(-n // rows)
    x = F.pad(t.float().reshape(b, n, c // ch, ch), (0, w - ch))
    x = F.pad(x, (0, 0, 0, 0, 0, s * rows - n), value=fill)
    return x.reshape(b, s, rows, c // ch, w).permute(0, 3, 1, 2, 4)


def _partials(k, v, q, g, ch: int) -> torch.Tensor:
    grad = q is not None
    rows = chunk_rows(ch, grad)
    kc = _chunked(k, ch, rows, float("-inf"))
    vc = _chunked(v, ch, rows, 0.0)
    m = kc.amax(dim=3)                                   # (B, heads, S, W)
    e = torch.exp(kc - m.unsqueeze(3))
    parts = [m, e.sum(dim=3), torch.einsum("bhsrk,bhsrv->bhskv", e, vc).flatten(3)]
    if grad:
        qc, gc = _chunked(q, ch, rows, 0.0), _chunked(g, ch, rows, 0.0)
        parts.append(torch.einsum("bhsrk,bhsrv->bhskv", qc, gc).flatten(3))
    ws = torch.cat(parts, dim=-1)                        # (B, heads, S, P)
    return ws.reshape(ws.shape[0] * ws.shape[1], -1).contiguous()


def factorized_attention_partials_ref(k: torch.Tensor, v: torch.Tensor, ch: int) -> torch.Tensor:
    """Plain forward partials in the kernels' workspace layout:
    (B·heads, S·P) fp32, per (b, h) the S chunks of its N rows in order, each
    [m_s, l_s, T_s] (``partial_floats``)."""
    return _partials(k, v, None, None, ch)


def factorized_attention_bwd_partials_ref(q, k, v, g, ch: int) -> torch.Tensor:
    """Plain backward partials: [m_s, l_s, T_s, D_s] a chunk."""
    return _partials(k, v, q, g, ch)


def _fold(ws: torch.Tensor, ch: int, grad: bool):
    """M, L (BH, W), T = Σ a_s T_s / L (BH, W, W) and Σ D_s of a workspace
    of any number of partials a (b, h), folded in their order."""
    w, p = attn_bucket(ch), partial_floats(ch, grad)
    part = ws.reshape(ws.shape[0], -1, p)
    m, l = part[..., :w], part[..., w:2 * w]
    t = part[..., 2 * w:2 * w + w * w].unflatten(-1, (w, w))
    mx = m.amax(dim=1)
    a = torch.where(m > float("-inf"), torch.exp(m - mx.unsqueeze(1)), torch.zeros_like(m))
    big_l = (a * l).sum(dim=1)
    t = (a.unsqueeze(-1) * t).sum(dim=1) / big_l.unsqueeze(-1)
    d = part[..., 2 * w + w * w:].unflatten(-1, (w, w)).sum(dim=1) if grad else None
    return mx, big_l, t, d


def _heads_wide(t: torch.Tensor, ch: int) -> torch.Tensor:
    b, n, c = t.shape
    return F.pad(t.float().reshape(b, n, c // ch, ch), (0, attn_bucket(ch) - ch))


def factorized_attention_apply_ref(q: torch.Tensor, ws: torch.Tensor, ch: int,
                                   scale: float) -> torch.Tensor:
    """Plain forward apply: folds every partial of ``ws`` (this call's or
    all ranks' gathered) and writes scale·q·T for q's rows."""
    b, n, c = q.shape
    _, _, t, _ = _fold(ws, ch, False)
    t = t.reshape(b, c // ch, *t.shape[1:])
    out = scale * torch.einsum("bnhk,bhkv->bnhv", _heads_wide(q, ch), t)
    return out[..., :ch].reshape(b, n, c).to(q.dtype)


def factorized_attention_bwd_apply_ref(k, v, g, ws: torch.Tensor, ch: int, scale: float):
    """Plain backward apply: from the folded M, L, T and dT = scale·ΣD_s,
    dq = scale·g·Tᵀ, dv = ks·dT, dk = ks ⊙ (v·dTᵀ − inner) for k's rows,
    ks = exp(k − M)/L, inner[i] = Σ_j dT[i, j]·T[i, j]."""
    b, n, c = k.shape
    heads = c // ch
    mx, big_l, t, d = _fold(ws, ch, True)
    mx, big_l = (x.reshape(b, 1, heads, -1) for x in (mx, big_l))
    t = t.reshape(b, heads, *t.shape[1:])
    dt = scale * d.reshape(b, heads, *d.shape[1:])
    kw, vw, gw = (_heads_wide(x, ch) for x in (k, v, g))
    ks = torch.exp(kw - mx) / big_l
    dq = scale * torch.einsum("bnhv,bhkv->bnhk", gw, t)
    dv = torch.einsum("bnhk,bhkv->bnhv", ks, dt)
    dks = torch.einsum("bnhv,bhkv->bnhk", vw, dt)
    inner = (dt * t).sum(dim=-1).unsqueeze(1)           # (B, 1, heads, W)
    dk = ks * (dks - inner)
    return tuple(x[..., :ch].reshape(b, n, c).to(k.dtype) for x in (dq, dk, dv))


def _check(q, k, v, ch):
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("factorized_attention: q, k, v must share one CUDA device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("factorized_attention: q, k, v must share one dtype")
    if q.dim() != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"factorized_attention: want equal (B, N, C) shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= ch <= MAX_CH or q.shape[2] % ch:
        raise ValueError(f"factorized_attention: ch={ch} with C={q.shape[2]} "
                         f"not supported (the kernels take 1 <= ch <= {MAX_CH} "
                         "dividing C)")
    if any(t.stride(2) != 1 for t in (q, k, v)) or not (
            q.stride() == k.stride() == v.stride()):
        raise ValueError("factorized_attention: q, k, v need unit channel "
                         "stride and equal strides")


def _workspace(lib, q, ch, grad: bool) -> torch.Tensor:
    """The fp32 workspace of one call's partials, in the size the library
    gives for its chunking. Every entry is written by the partials launch
    before the apply reads it, so nothing is zeroed."""
    b, n, c = q.shape
    per_head = lib.mdvit_factorized_attention_workspace(n, ch, int(grad))
    if per_head <= 0:
        raise RuntimeError(f"factorized_attention: no workspace size for N={n}, ch={ch}")
    return torch.empty((b * (c // ch), per_head), dtype=torch.float32, device=q.device)


def _forward(q, k, v, ch, scale):
    """Two launches: per-chunk fp32 partials of k and v into a workspace, then
    the apply pass that folds them in a fixed order and writes scale·q·T."""
    if q.device.type == "cpu":
        return factorized_attention_ref(q, k, v, ch, scale)
    _check(q, k, v, ch)
    b, n, c = q.shape
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    if out.numel() == 0:  # no rows (a data-parallel rank's empty group): no launch
        return out
    lib = kernels.library("factorized_attention")
    ws = _workspace(lib, q, ch, grad=False)
    with torch.cuda.device(q.device):
        status = lib.mdvit_factorized_attention_fwd(
            kernels.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), ws.data_ptr(), b, n, c // ch, ch,
            q.stride(0), q.stride(1), float(scale),
            torch.cuda.current_stream().cuda_stream)
    kernels.check_status("factorized_attention", status)
    kernels.LAUNCHES["factorized_attention"] += 1
    return out


def _backward(q, k, v, g, ch, scale):
    """Two launches: per-chunk fp32 partials into a workspace, then the apply
    pass that folds them in a fixed order and writes dq, dk, dv."""
    _check(q, k, v, ch)
    g = _bwd_grad(q, g)
    b, n, c = q.shape
    dq, dk, dv = (torch.empty((b, n, c), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    lib = kernels.library("factorized_attention")
    ws = _workspace(lib, q, ch, grad=True)
    with torch.cuda.device(q.device):
        status = lib.mdvit_factorized_attention_bwd(
            kernels.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ws.data_ptr(), b, n, c // ch, ch, q.stride(0),
            q.stride(1), g.stride(0), g.stride(1), float(scale),
            torch.cuda.current_stream().cuda_stream)
    kernels.check_status("factorized_attention_bwd", status)
    kernels.LAUNCHES["factorized_attention_bwd"] += 1
    return dq, dk, dv


@functools.cache
def _library_chunking(ch: int) -> None:
    """Raise unless the library chunks as ``ATTN_*CHUNK_ROWS`` and
    ``partial_floats`` say and sizes a workspace of S chunks as S partials: a
    drifted mirror would size a gathered workspace wrong and a kernel would
    read or write past it. Checked once a head width."""
    lib = kernels.library("factorized_attention")
    for grad in (0, 1):
        rows = lib.mdvit_factorized_attention_chunk_rows(ch, grad)
        size = lib.mdvit_factorized_attention_partial(ch, grad)
        ws = lib.mdvit_factorized_attention_workspace(2 * rows + 1, ch, grad)
        if rows != chunk_rows(ch, bool(grad)) or size != partial_floats(ch, bool(grad)) \
                or ws != 3 * size:
            raise RuntimeError(f"factorized_attention: the library's chunking at ch={ch} "
                               f"({rows} rows, {size} floats, {ws} for 3 chunks) is not "
                               "the wrapper's")


def _split_workspace(lib, q, ch, grad: bool) -> torch.Tensor:
    _library_chunking(ch)
    return _workspace(lib, q, ch, grad)


def _fold_count(ws: torch.Tensor, q: torch.Tensor, ch: int, grad: bool) -> int:
    b, _, c = q.shape
    p = partial_floats(ch, grad)
    if ws.dtype != torch.float32 or ws.dim() != 2 or ws.shape[0] != b * (c // ch) \
            or ws.shape[1] % p or ws.shape[1] == 0 or not ws.is_contiguous() \
            or ws.device != q.device:
        raise ValueError(f"factorized_attention: want a contiguous fp32 ({b * (c // ch)}, "
                         f"S·{p}) workspace on q's device, got {tuple(ws.shape)}")
    return ws.shape[1] // p


def _fwd_partials(k, v, ch):
    """Launch 1 of the forward alone: this call's partials into a workspace."""
    _check(k, k, v, ch)
    b, n, c = k.shape
    lib = kernels.library("factorized_attention")
    ws = _split_workspace(lib, k, ch, grad=False)
    with torch.cuda.device(k.device):
        status = lib.mdvit_factorized_attention_fwd_partials(
            kernels.dtype_code(k.dtype), k.data_ptr(), v.data_ptr(), ws.data_ptr(), b, n,
            c // ch, ch, k.stride(0), k.stride(1), torch.cuda.current_stream().cuda_stream)
    kernels.check_status("factorized_attention_partials", status)
    return ws


def _fwd_apply(q, ws, ch, scale):
    """Launch 2 of the forward alone: folds every partial of ``ws``."""
    _check(q, q, q, ch)
    fold = _fold_count(ws, q, ch, grad=False)
    b, n, c = q.shape
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    lib = kernels.library("factorized_attention")
    with torch.cuda.device(q.device):
        status = lib.mdvit_factorized_attention_fwd_apply(
            kernels.dtype_code(q.dtype), q.data_ptr(), ws.data_ptr(), out.data_ptr(), b, n,
            c // ch, ch, fold, q.stride(0), q.stride(1), float(scale),
            torch.cuda.current_stream().cuda_stream)
    kernels.check_status("factorized_attention_apply", status)
    kernels.LAUNCHES["factorized_attention"] += 1
    return out


def _bwd_grad(q, g):
    if g.device != q.device or g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError("factorized_attention backward: the output gradient "
                         "must match q's device, dtype and shape")
    return g if g.stride(2) == 1 else g.contiguous()


def _bwd_partials(q, k, v, g, ch):
    _check(q, k, v, ch)
    g = _bwd_grad(q, g)
    b, n, c = q.shape
    lib = kernels.library("factorized_attention")
    ws = _split_workspace(lib, q, ch, grad=True)
    with torch.cuda.device(q.device):
        status = lib.mdvit_factorized_attention_bwd_partials(
            kernels.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), ws.data_ptr(), b, n, c // ch, ch, q.stride(0), q.stride(1),
            g.stride(0), g.stride(1), torch.cuda.current_stream().cuda_stream)
    kernels.check_status("factorized_attention_bwd_partials", status)
    return ws


def _bwd_apply(k, v, g, ws, ch, scale):
    _check(k, k, v, ch)
    g = _bwd_grad(k, g)
    fold = _fold_count(ws, k, ch, grad=True)
    b, n, c = k.shape
    dq, dk, dv = (torch.empty((b, n, c), dtype=k.dtype, device=k.device) for _ in range(3))
    lib = kernels.library("factorized_attention")
    with torch.cuda.device(k.device):
        status = lib.mdvit_factorized_attention_bwd_apply(
            kernels.dtype_code(k.dtype), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            ws.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, c // ch, ch,
            fold, k.stride(0), k.stride(1), g.stride(0), g.stride(1), float(scale),
            torch.cuda.current_stream().cuda_stream)
    kernels.check_status("factorized_attention_bwd_apply", status)
    kernels.LAUNCHES["factorized_attention_bwd"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------- the ops
# The CUDA implementations look ``_forward``/``_backward`` up when called.


@torch.library.custom_op("mdvit::factorized_attention", mutates_args=(),
                         device_types="cuda")
def _attention_op(q: Tensor, k: Tensor, v: Tensor, ch: int, scale: float) -> Tensor:
    return _forward(q, k, v, ch, scale)


@_attention_op.register_kernel("cpu")
def _attention_cpu(q, k, v, ch, scale):
    return factorized_attention_ref(q, k, v, ch, scale).contiguous()


@_attention_op.register_fake
def _attention_fake(q, k, v, ch, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("mdvit::factorized_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, g: Tensor, ch: int,
                      scale: float) -> tuple[Tensor, Tensor, Tensor]:
    return _backward(q, k, v, g, ch, scale)


@_attention_bwd_op.register_kernel("cpu")
def _attention_bwd_cpu(q, k, v, g, ch, scale):
    return tuple(d.contiguous() for d in factorized_attention_bwd_ref(q, k, v, g, ch, scale))


@_attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, g, ch, scale):
    return tuple(q.new_empty(q.shape) for _ in range(3))


def _setup_context(ctx, inputs, output):
    q, k, v, ctx.ch, ctx.scale = inputs
    ctx.save_for_backward(q, k, v)


def _grad(ctx, g):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = torch.ops.mdvit.factorized_attention_bwd(q, k, v, g, ctx.ch, ctx.scale)
    return dq, dk, dv, None, None


_attention_op.register_autograd(_grad, setup_context=_setup_context)


def factorized_attention(q: Tensor, k: Tensor, v: Tensor, ch: int, scale: float) -> Tensor:
    """q, k, v (B, N, C) → (B, N, C) contiguous, in the input dtype.

    q, k and v may be strided views (e.g. slices of a (B, N, 3C) projection)
    with unit channel stride and equal strides; no copy is made."""
    return torch.ops.mdvit.factorized_attention(q, k, v, ch, scale)


# ---------------------------------------------------------------- the split ops
# The CUDA implementations look ``_fwd_partials`` … ``_bwd_apply`` up when
# called; the fakes size the workspace from the mirror of the chunking.


def _ws_fake(t: Tensor, ch: int, grad: bool) -> Tensor:
    b, n, c = t.shape
    return t.new_empty((b * (c // ch), -(-n // chunk_rows(ch, grad)) * partial_floats(ch, grad)),
                       dtype=torch.float32)


@torch.library.custom_op("mdvit::factorized_attention_partials", mutates_args=(),
                         device_types="cuda")
def _partials_op(k: Tensor, v: Tensor, ch: int) -> Tensor:
    return _fwd_partials(k, v, ch)


@_partials_op.register_kernel("cpu")
def _partials_cpu(k, v, ch):
    return factorized_attention_partials_ref(k, v, ch)


@_partials_op.register_fake
def _partials_fake(k, v, ch):
    return _ws_fake(k, ch, False)


@torch.library.custom_op("mdvit::factorized_attention_apply", mutates_args=(),
                         device_types="cuda")
def _apply_op(q: Tensor, ws: Tensor, ch: int, scale: float) -> Tensor:
    return _fwd_apply(q, ws, ch, scale)


@_apply_op.register_kernel("cpu")
def _apply_cpu(q, ws, ch, scale):
    return factorized_attention_apply_ref(q, ws, ch, scale).contiguous()


@_apply_op.register_fake
def _apply_fake(q, ws, ch, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("mdvit::factorized_attention_bwd_partials", mutates_args=(),
                         device_types="cuda")
def _bwd_partials_op(q: Tensor, k: Tensor, v: Tensor, g: Tensor, ch: int) -> Tensor:
    return _bwd_partials(q, k, v, g, ch)


@_bwd_partials_op.register_kernel("cpu")
def _bwd_partials_cpu(q, k, v, g, ch):
    return factorized_attention_bwd_partials_ref(q, k, v, g, ch)


@_bwd_partials_op.register_fake
def _bwd_partials_fake(q, k, v, g, ch):
    return _ws_fake(q, ch, True)


@torch.library.custom_op("mdvit::factorized_attention_bwd_apply", mutates_args=(),
                         device_types="cuda")
def _bwd_apply_op(k: Tensor, v: Tensor, g: Tensor, ws: Tensor, ch: int,
                  scale: float) -> tuple[Tensor, Tensor, Tensor]:
    return _bwd_apply(k, v, g, ws, ch, scale)


@_bwd_apply_op.register_kernel("cpu")
def _bwd_apply_cpu(k, v, g, ws, ch, scale):
    return tuple(d.contiguous() for d in factorized_attention_bwd_apply_ref(k, v, g, ws, ch,
                                                                            scale))


@_bwd_apply_op.register_fake
def _bwd_apply_fake(k, v, g, ws, ch, scale):
    return tuple(k.new_empty(k.shape) for _ in range(3))


def pad_partials(ws: Tensor, chunks: int, ch: int, grad: bool) -> Tensor:
    """(BH, S·P) → (BH, chunks·P): the S partials of each (b, h) followed by
    empty ones (m = −∞, l = 0, T = 0, D = 0), which every fold skips."""
    p, w = partial_floats(ch, grad), attn_bucket(ch)
    s = ws.shape[1] // p
    if s == chunks:
        return ws
    empty = ws.new_zeros((ws.shape[0], chunks - s, p))
    empty[..., :w] = float("-inf")
    return torch.cat([ws.reshape(ws.shape[0], s, p), empty], dim=1).reshape(ws.shape[0], -1)


def gather_partials(ws: Tensor, group: Any, chunks: int, ch: int, grad: bool) -> Tensor:
    """(BH, S·P) → (BH, n·chunks·P): every rank's partials of each (b, h), in
    rank order, each rank's padded to ``chunks`` (the most any rank holds)
    with empty partials (one all-gather over ``group``, in the span
    ``mdvit.cp.gather``)."""
    with collective("gather"):
        ws = counted("gather", pad_partials(ws, chunks, ch, grad).contiguous())
        parts = [torch.empty_like(ws) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, ws, group=group)
        return torch.stack(parts, dim=1).reshape(ws.shape[0], -1)


def _most_chunks(tokens, ch: int, grad: bool) -> int:
    rows = chunk_rows(ch, grad)
    return max(-(-t // rows) for t in tokens)


class _AttentionCP(torch.autograd.Function):
    """Partials → gather → apply, forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, ch, scale, group, tokens):
        ws = gather_partials(torch.ops.mdvit.factorized_attention_partials(k, v, ch), group,
                             _most_chunks(tokens, ch, False), ch, False)
        ctx.save_for_backward(q, k, v)
        ctx.ch, ctx.scale, ctx.group, ctx.tokens = ch, scale, group, tokens
        return torch.ops.mdvit.factorized_attention_apply(q, ws, ch, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        ws = gather_partials(torch.ops.mdvit.factorized_attention_bwd_partials(
            q, k, v, g, ctx.ch), ctx.group, _most_chunks(ctx.tokens, ctx.ch, True), ctx.ch, True)
        dq, dk, dv = torch.ops.mdvit.factorized_attention_bwd_apply(k, v, g, ws, ctx.ch,
                                                                    ctx.scale)
        return dq, dk, dv, None, None, None, None


def factorized_attention_cp(q: Tensor, k: Tensor, v: Tensor, ch: int, scale: float,
                            group: Any, tokens: Sequence[int]) -> Tensor:
    """``factorized_attention`` of a block of the tokens held by each rank of
    ``group``, in rank order, ``tokens[r]`` of them on rank r: the softmax
    over all ranks' tokens and Σ over them of ksᵀv; returns this rank's
    rows. The apply folds n × the most chunks any rank holds, the missing
    ones empty."""
    return _AttentionCP.apply(q, k, v, ch, scale, group, tuple(tokens))
