"""Fused depthwise convs of the MHSA stages, channel-last (B, H, W, C).

Counterpart of ``mdvit_tpu/ops/pallas_dwconv.py``:

* ``cpe_conv(x, w, b)``     → ``dwconv₃ₓ₃(x) + b + x``  (ConvPosEnc)
* ``crpe_conv(q, v, w, b)`` → ``q · (dwconv₇ₓ₇(v) + b)`` (ConvRelPosEnc)

Stride 1, zero SAME padding, w (K, K, C), b (C,). Each is a ``torch.library``
custom op (``mdvit::cpe_conv``, ``mdvit::crpe_conv``) with a backward op
beside it (``mdvit::cpe_conv_bwd``, ``mdvit::crpe_conv_bwd``). On a CUDA
tensor an op launches its tiled kernels of ``csrc/dwconv.cu`` (one launch
forward, a fused tile kernel and a reduce backward); on a CPU tensor it runs
its plain PyTorch version (``cpe_conv_ref``/``cpe_conv_bwd_ref``,
``crpe_conv_ref``/``crpe_conv_bwd_ref``), which sums the taps in the same
order in fp32 and rounds once, as the Pallas kernels do; under
``torch.export`` or a fake tensor its fake gives the output's shape.

The forward ops' registered autograd (the Pallas ``custom_vjp``) calls the
backward op: the image-shaped gradients are dwconvs with the flipped kernel,
and dw, db are fp32 sums over batch and space. The backward op returns them
stacked as one (K·K + 1, C) fp32 tensor (an op's outputs may not alias each
other); the autograd formula splits it and casts dw, db to w's and b's
dtypes, as ``_cpe_vjp_bwd``/``_crpe_vjp_bwd`` do. The backward ops have no
autograd of their own: a double backward raises. Importing this module
registers the ops and builds nothing; the first CUDA call builds the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from mdvit_tpu_torch.ops import kernels


def _dwconv_fp32(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """Σ_ky,kx xpad[:, ky:ky+H, kx:kx+W, :] · w[ky, kx] in fp32 (shift and
    add); ``flip`` convolves with w turned by 180°."""
    k = w.shape[0]
    p = k // 2
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    wf = w.float().flip(0, 1) if flip else w.float()
    acc = None
    for ky in range(k):
        for kx in range(k):
            term = xp[:, ky:ky + h, kx:kx + wd, :] * wf[ky, kx]
            acc = term if acc is None else acc + term
    return acc


def _weight_grads(x: torch.Tensor, u: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """dw[ky, kx] = Σ xpad[:, ky:ky+H, kx:kx+W] · u and db = Σ u, fp32."""
    p = k // 2
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    dw = torch.stack([
        torch.stack([(xp[:, ky:ky + h, kx:kx + wd, :] * u).sum(dim=(0, 1, 2))
                     for kx in range(k)]) for ky in range(k)])
    return dw, u.sum(dim=(0, 1, 2))


def cpe_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cpe_conv``."""
    return (_dwconv_fp32(x, w) + b.float() + x.float()).to(x.dtype)


def cpe_conv_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Plain backward of ``cpe_conv`` (``_cpe_bwd_kernel``): dx in x's dtype,
    dw (K, K, C) and db (C,) in fp32."""
    gf = g.float()
    dx = (_dwconv_fp32(gf, w, flip=True) + gf).to(x.dtype)
    dw, db = _weight_grads(x, gf, w.shape[0])
    return dx, dw, db


def crpe_conv_ref(q: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``crpe_conv``."""
    return (q.float() * (_dwconv_fp32(v, w) + b.float())).to(q.dtype)


def crpe_conv_bwd_ref(q: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, g: torch.Tensor):
    """Plain backward of ``crpe_conv`` (``_crpe_bwd_kernel``): with
    u = g ⊙ q, dq = g ⊙ (dwconv(v) + b), dv = dwconv(u, flipped w),
    dw = Σ vpad·u, db = Σ u; dq, dv in the input dtype, dw, db fp32."""
    gf = g.float()
    dq = (gf * (_dwconv_fp32(v, w) + b.float())).to(q.dtype)
    u = gf * q.float()
    dv = _dwconv_fp32(u, w, flip=True).to(v.dtype)
    dw, db = _weight_grads(v, u, w.shape[0])
    return dq, dv, dw, db


def _check_grid(name, k, w, b, *grids):
    x = grids[0]
    for t in (*grids, w) + (() if b is None else (b,)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must share one CUDA device")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: all tensors must share one dtype")
    bsz, h, wd, c = x.shape
    for t in grids:
        if t.dim() != 4 or tuple(t.shape) != (bsz, h, wd, c):
            raise ValueError(f"{name}: want equal (B, H, W, C) inputs")
        if t.stride(3) != 1 or t.stride(1) != wd * t.stride(2):
            raise ValueError(f"{name}: inputs need unit channel stride and "
                             "rows of W pixels")
    if tuple(w.shape) != (k, k, c) or not w.is_contiguous():
        raise ValueError(f"{name}: want a contiguous ({k}, {k}, {c}) kernel, "
                         f"got {tuple(w.shape)}")
    if b is not None and (tuple(b.shape) != (c,) or not b.is_contiguous()):
        raise ValueError(f"{name}: want a contiguous ({c},) bias")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _weight_scratch(x: torch.Tensor, k: int, tiles: int):
    """Per-tile partial sums of (dw, db) and their fixed-order total (fp32)."""
    c = x.shape[3]
    partial = torch.empty((tiles, k * k + 1, c), dtype=torch.float32, device=x.device)
    total = torch.empty((k * k + 1, c), dtype=torch.float32, device=x.device)
    return partial, total


def _copy_bytes(*views: torch.Tensor) -> int:
    """Bytes per halo copy of the tiled kernels: the widest of 16, 8, 4 (and
    2 for bf16) that divides every pointer and, in elements, C and each
    view's pixel and batch strides. The main path's C = 64/128/320/512, with
    contiguous x and 3C-strided q, v, takes 16."""
    item = views[0].element_size()
    c = views[0].shape[3]
    for vec in (16, 8, 4):
        n = vec // item
        if c % n == 0 and all(t.data_ptr() % vec == 0 and t.stride(2) % n == 0
                              and t.stride(0) % n == 0 for t in views):
            return vec
    return item


def _check_int32(name, *views):
    """The tiled kernels index within one image in 32 bits."""
    for t in views:
        if t.shape[1] * t.shape[2] * max(t.stride(2), t.shape[3]) >= 2 ** 31:
            raise ValueError(f"{name}: an image of {tuple(t.shape[1:])} with pixel "
                             f"stride {t.stride(2)} overflows 32-bit indices")


def _cpe_forward(x, w, b):
    _check_grid("cpe_conv", 3, w, b, x)
    _check_int32("cpe_conv", x)
    bsz, h, wd, c = x.shape
    out = torch.empty((bsz, h, wd, c), dtype=x.dtype, device=x.device)
    lib = kernels.library("dwconv")
    with torch.cuda.device(x.device):
        status = lib.mdvit_cpe_conv_fwd(
            kernels.dtype_code(x.dtype), x.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), bsz, h, wd, c, x.stride(0),
            x.stride(2), _copy_bytes(x, out), _stream())
    kernels.check_status("cpe_conv", status)
    kernels.LAUNCHES["cpe_conv"] += 1
    return out


def _cpe_backward(x, w, g):
    g = g.contiguous()
    _check_grid("cpe_conv_bwd", 3, w, None, x, g)
    _check_int32("cpe_conv_bwd", x, g)
    bsz, h, wd, c = x.shape
    dx = torch.empty((bsz, h, wd, c), dtype=x.dtype, device=x.device)
    partial, total = _weight_scratch(x, 3, kernels.dwconv_weight_tiles(bsz, h, wd))
    lib = kernels.library("dwconv")
    with torch.cuda.device(x.device):
        status = lib.mdvit_cpe_conv_bwd(
            kernels.dtype_code(x.dtype), x.data_ptr(), w.data_ptr(),
            g.data_ptr(), dx.data_ptr(), partial.data_ptr(), total.data_ptr(),
            partial.shape[0], bsz, h, wd, c, x.stride(0), x.stride(2),
            _copy_bytes(x, g, dx), _stream())
    kernels.check_status("cpe_conv_bwd", status)
    kernels.LAUNCHES["cpe_conv_bwd"] += 1
    return dx, total


def _crpe_forward(q, v, w, b):
    _check_grid("crpe_conv", 7, w, b, q, v)
    _check_int32("crpe_conv", q, v)
    bsz, h, wd, c = q.shape
    out = torch.empty((bsz, h, wd, c), dtype=q.dtype, device=q.device)
    lib = kernels.library("dwconv")
    with torch.cuda.device(q.device):
        status = lib.mdvit_crpe_conv_fwd(
            kernels.dtype_code(q.dtype), q.data_ptr(), v.data_ptr(),
            w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wd, c,
            q.stride(0), q.stride(2), v.stride(0), v.stride(2),
            _copy_bytes(q, v, out), _stream())
    kernels.check_status("crpe_conv", status)
    kernels.LAUNCHES["crpe_conv"] += 1
    return out


def _crpe_backward(q, v, w, b, g):
    g = g.contiguous()
    _check_grid("crpe_conv_bwd", 7, w, b, q, v, g)
    _check_int32("crpe_conv_bwd", q, v, g)
    bsz, h, wd, c = q.shape
    dq, dv = (torch.empty((bsz, h, wd, c), dtype=q.dtype, device=q.device)
              for _ in range(2))
    partial, total = _weight_scratch(q, 7, kernels.dwconv_weight_tiles(bsz, h, wd))
    lib = kernels.library("dwconv")
    with torch.cuda.device(q.device):
        status = lib.mdvit_crpe_conv_bwd(
            kernels.dtype_code(q.dtype), q.data_ptr(), v.data_ptr(),
            w.data_ptr(), b.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dv.data_ptr(), partial.data_ptr(), total.data_ptr(),
            partial.shape[0], bsz, h, wd, c, q.stride(0), q.stride(2),
            v.stride(0), v.stride(2), _copy_bytes(q, v, g, dq, dv), _stream())
    kernels.check_status("crpe_conv_bwd", status)
    kernels.LAUNCHES["crpe_conv_bwd"] += 1
    return dq, dv, total


# ---------------------------------------------------------------- the ops
# The CUDA implementations look ``_cpe_forward`` … ``_crpe_backward`` up when
# called. The backward ops return dw and db as one (K·K + 1, C) fp32 tensor.


def _stacked(dw: Tensor, db: Tensor) -> Tensor:
    return torch.cat([dw.reshape(-1, dw.shape[-1]), db[None]])


@torch.library.custom_op("mdvit::cpe_conv", mutates_args=(), device_types="cuda")
def _cpe_op(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    return _cpe_forward(x, w, b)


@_cpe_op.register_kernel("cpu")
def _cpe_cpu(x, w, b):
    return cpe_conv_ref(x, w, b).contiguous()


@_cpe_op.register_fake
def _cpe_fake(x, w, b):
    return x.new_empty(x.shape)


@torch.library.custom_op("mdvit::cpe_conv_bwd", mutates_args=(), device_types="cuda")
def _cpe_bwd_op(x: Tensor, w: Tensor, g: Tensor) -> tuple[Tensor, Tensor]:
    return _cpe_backward(x, w, g)


@_cpe_bwd_op.register_kernel("cpu")
def _cpe_bwd_cpu(x, w, g):
    dx, dw, db = cpe_conv_bwd_ref(x, w, g)
    return dx.contiguous(), _stacked(dw, db)


@_cpe_bwd_op.register_fake
def _cpe_bwd_fake(x, w, g):
    k, c = w.shape[0], x.shape[3]
    return x.new_empty(x.shape), x.new_empty((k * k + 1, c), dtype=torch.float32)


@torch.library.custom_op("mdvit::crpe_conv", mutates_args=(), device_types="cuda")
def _crpe_op(q: Tensor, v: Tensor, w: Tensor, b: Tensor) -> Tensor:
    return _crpe_forward(q, v, w, b)


@_crpe_op.register_kernel("cpu")
def _crpe_cpu(q, v, w, b):
    return crpe_conv_ref(q, v, w, b).contiguous()


@_crpe_op.register_fake
def _crpe_fake(q, v, w, b):
    return q.new_empty(q.shape)


@torch.library.custom_op("mdvit::crpe_conv_bwd", mutates_args=(), device_types="cuda")
def _crpe_bwd_op(q: Tensor, v: Tensor, w: Tensor, b: Tensor,
                 g: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    return _crpe_backward(q, v, w, b, g)


@_crpe_bwd_op.register_kernel("cpu")
def _crpe_bwd_cpu(q, v, w, b, g):
    dq, dv, dw, db = crpe_conv_bwd_ref(q, v, w, b, g)
    return dq.contiguous(), dv.contiguous(), _stacked(dw, db)


@_crpe_bwd_op.register_fake
def _crpe_bwd_fake(q, v, w, b, g):
    k, c = w.shape[0], q.shape[3]
    return (q.new_empty(q.shape), q.new_empty(q.shape),
            q.new_empty((k * k + 1, c), dtype=torch.float32))


def _split(dwb: Tensor, w: Tensor, b_dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    """dw (K, K, C) in w's dtype and db (C,) in ``b_dtype`` of a stacked
    (K·K + 1, C) fp32 weight gradient."""
    return dwb[:-1].reshape(w.shape).to(w.dtype), dwb[-1].to(b_dtype)


def _cpe_setup(ctx, inputs, output):
    x, w, b = inputs
    ctx.save_for_backward(x, w)
    ctx.b_dtype = b.dtype


def _cpe_grad(ctx, g):
    x, w = ctx.saved_tensors
    dx, dwb = torch.ops.mdvit.cpe_conv_bwd(x, w, g)
    return (dx, *_split(dwb, w, ctx.b_dtype))


def _crpe_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _crpe_grad(ctx, g):
    q, v, w, b = ctx.saved_tensors
    dq, dv, dwb = torch.ops.mdvit.crpe_conv_bwd(q, v, w, b, g)
    return (dq, dv, *_split(dwb, w, b.dtype))


_cpe_op.register_autograd(_cpe_grad, setup_context=_cpe_setup)
_crpe_op.register_autograd(_crpe_grad, setup_context=_crpe_setup)


def cpe_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """``dwconv₃ₓ₃(x) + b + x``; x (B, H, W, C) → contiguous (B, H, W, C)."""
    return torch.ops.mdvit.cpe_conv(x, w, b)


def crpe_conv(q: Tensor, v: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """``q · (dwconv₇ₓ₇(v) + b)``; q, v (B, H, W, C) → contiguous (B, H, W, C).

    q and v may be strided views with unit channel stride (e.g. slices of a
    (B, H, W, 3C) projection); no copy is made."""
    return torch.ops.mdvit.crpe_conv(q, v, w, b)
