"""The six kernels as ``torch.library`` custom ops (``torch.ops.mdvit.*``),
on the CPU, where each runs its plain PyTorch version.

* ``torch.library.opcheck`` of every op at two small shapes, fp32, with q,
  k, v (and CRPE's q, v) as strided slices of one projection, as the model
  gives them: the schema, the fake against the CPU implementation, the
  autograd registration, and the op under ``aot_autograd``.
* Each forward op's gradients, through its registered autograd, equal its
  plain backward's (dw, db cast to the parameters' dtype).
* A double backward raises.
* Every op has a CUDA and a CPU kernel and no kernel that serves every
  device, so a CUDA tensor cannot reach a plain version; the
  ``autograd.Function`` routes are gone.
"""
import numpy as np
import pytest
import torch

from mdvit_tpu_torch.ops import dwconv
from mdvit_tpu_torch.ops import factorized_attention as fa

torch.set_num_threads(2)

FORWARD = ("factorized_attention", "cpe_conv", "crpe_conv")
OPS = FORWARD + tuple(f"{name}_bwd" for name in FORWARD)
# (B, H, W, C, ch): a square grid, and an odd one narrower than a tile
SHAPES = [(2, 4, 4, 16, 8), (1, 3, 5, 24, 8)]


def _inputs(name: str, shape, seed: int = 0, grad: bool = True) -> tuple:
    """The op's arguments: slices of one projection for q, k, v."""
    b, h, w, c, ch = shape
    rs = np.random.RandomState(seed)

    def t(*s, std=1.0):
        return torch.from_numpy((rs.standard_normal(s) * std).astype(np.float32))

    kind = name.removesuffix("_bwd")
    bwd = name.endswith("_bwd")
    if kind == "factorized_attention":
        qkv = t(b, h * w, 3 * c).requires_grad_(grad and not bwd)
        args = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])
        return args + ((t(b, h * w, c),) if bwd else ()) + (ch, ch ** -0.5)
    if kind == "cpe_conv":
        leaves = [t(b, h, w, c), t(3, 3, c, std=0.5), t(c, std=0.1)]
        x, wt, bias = (x.requires_grad_(grad and not bwd) for x in leaves)
        return (x, wt, t(b, h, w, c)) if bwd else (x, wt, bias)
    qkv = t(b, h, w, 3 * c).requires_grad_(grad and not bwd)
    wt, bias = (x.requires_grad_(grad and not bwd) for x in (t(7, 7, c, std=0.2), t(c, std=0.1)))
    args = (qkv[..., :c], qkv[..., 2 * c:], wt, bias)
    return args + (t(b, h, w, c),) if bwd else args


@pytest.mark.parametrize("shape", SHAPES, ids=["4x4", "3x5"])
@pytest.mark.parametrize("name", OPS)
def test_opcheck(name, shape):
    op = getattr(torch.ops.mdvit, name).default
    torch.library.opcheck(op, _inputs(name, shape))


def _leaves(name: str, args: tuple) -> list:
    if name == "factorized_attention":
        return [args[0]._base]
    if name == "crpe_conv":
        return [args[0]._base, args[2], args[3]]
    return list(args)


@pytest.mark.parametrize("name", FORWARD)
def test_gradients_are_the_plain_backward(name):
    args = _inputs(name, SHAPES[1])
    out = getattr(torch.ops.mdvit, name)(*args)
    g = torch.from_numpy(np.random.RandomState(9).standard_normal(out.shape)
                         .astype(np.float32))
    got = torch.autograd.grad(out, _leaves(name, args), g)
    plain = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
    if name == "factorized_attention":
        want = [torch.cat(fa.factorized_attention_bwd_ref(*plain[:3], g, *plain[3:]), -1)]
    elif name == "cpe_conv":
        want = list(dwconv.cpe_conv_bwd_ref(plain[0], plain[1], g))
    else:
        dq, dv, dw, db = dwconv.crpe_conv_bwd_ref(*plain, g)
        want = [torch.cat([dq, torch.zeros_like(dq), dv], -1), dw, db]
    for a, e, leaf in zip(got, want, _leaves(name, args)):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape
        torch.testing.assert_close(a, e.to(leaf.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("name", FORWARD)
def test_double_backward_raises(name):
    args = _inputs(name, SHAPES[0])
    out = getattr(torch.ops.mdvit, name)(*args)
    grads = torch.autograd.grad(out.square().sum(), _leaves(name, args), create_graph=True)
    with pytest.raises(RuntimeError, match="no autograd formula"):
        torch.autograd.grad(sum(g.sum() for g in grads), _leaves(name, args))


@pytest.mark.parametrize("name", OPS)
def test_one_route_a_device(name):
    qualified = f"mdvit::{name}"
    for key in ("CUDA", "CPU", "Meta", "Autograd"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), key
    for key in ("CompositeExplicitAutograd", "CompositeImplicitAutograd"):
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), key
    for module, gone in ((fa, "_FactorizedAttention"), (dwconv, "_CpeConv"),
                         (dwconv, "_CrpeConv")):
        assert not hasattr(module, gone)


def test_public_functions_call_the_ops():
    """``factorized_attention``, ``cpe_conv`` and ``crpe_conv`` give the
    ops' outputs, contiguous, and take the projection's views as they are."""
    for name, fn in (("factorized_attention", fa.factorized_attention),
                     ("cpe_conv", dwconv.cpe_conv), ("crpe_conv", dwconv.crpe_conv)):
        args = _inputs(name, SHAPES[0], grad=False)
        got = fn(*args)
        assert got.is_contiguous()
        assert torch.equal(got, getattr(torch.ops.mdvit, name)(*args))
