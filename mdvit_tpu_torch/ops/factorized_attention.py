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
"""
from __future__ import annotations

import torch
from torch import Tensor

from mdvit_tpu_torch.ops import kernels

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
    if g.device != q.device or g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError("factorized_attention backward: the output gradient "
                         "must match q's device, dtype and shape")
    g = g if g.stride(2) == 1 else g.contiguous()
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
