"""Factorized attention ``scale · q_h · (softmaxₙ(k_h)ᵀ v_h)`` per head.

Counterpart of ``mdvit_tpu/ops/pallas_attention.py``. ``factorized_attention``
launches the CUDA kernels of ``csrc/factorized_attention.cu`` on a CUDA tensor
and runs the plain PyTorch versions (``factorized_attention_ref``,
``factorized_attention_bwd_ref``) on a CPU tensor. All take the softmax over
the N tokens in fp32, accumulate in fp32 and round once to the input dtype,
as the Pallas kernels do.

When an input needs a gradient the call goes through ``_FactorizedAttention``
(an ``autograd.Function``, as the Pallas kernel's ``custom_vjp``): its
backward recomputes the softmax from the saved q, k, v, so no (B, N, C)
softmax is kept for the backward. Without one (serving under ``no_grad``)
the forward is called directly, with no autograd bookkeeping.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from mdvit_tpu_torch.ops import kernels

# head widths the kernels are instantiated for: MDViT's four stages
KERNEL_CH = (8, 16, 40, 64)


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
    if ch not in KERNEL_CH or q.shape[2] % ch:
        raise ValueError(f"factorized_attention: ch={ch} with C={q.shape[2]} "
                         f"not supported (kernel has ch in {KERNEL_CH})")
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
    if q.device.type == "cpu":
        return factorized_attention_bwd_ref(q, k, v, g, ch, scale)
    _check(q, k, v, ch)
    if g.device != q.device or g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError("factorized_attention backward: the output gradient "
                         "must match q's device, dtype and shape")
    g = g if g.stride(2) == 1 else g.contiguous()
    b, n, c = q.shape
    dq, dk, dv = (torch.empty((b, n, c), dtype=q.dtype, device=q.device)
                  for _ in range(3))
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


class _FactorizedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ch, scale):
        ctx.save_for_backward(q, k, v)
        ctx.ch, ctx.scale = ch, scale
        return _forward(q, k, v, ch, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, g, ctx.ch, ctx.scale)
        return dq, dk, dv, None, None


def factorized_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         ch: int, scale: float) -> torch.Tensor:
    """q, k, v (B, N, C) → (B, N, C) contiguous, in the input dtype.

    q, k and v may be strided views (e.g. slices of a (B, N, 3C) projection)
    with unit channel stride and equal strides; no copy is made."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FactorizedAttention.apply(q, k, v, ch, scale)
    return _forward(q, k, v, ch, scale)
