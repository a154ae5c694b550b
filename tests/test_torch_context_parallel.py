"""The port's context parallelism at the stage level
(``mdvit_tpu_torch/parallel/context.py``) on the CPU: the split plain
versions of kernels A and A′ (partials of row blocks, gathered, applied),
the halo exchange, and one ``MHSAStage`` row-sharded over gloo ranks
(``tests/torch_cp.py``) against JAX's unsharded stage
(``tests/test_context_parallel.py``'s sizes and tolerances), with each
shard's dropout mask against JAX's ``FastDropout(axis_name="ctx")``."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_cp
import torch_dp
from mdvit_tpu.models.blocks import MHSAStage as JaxMHSAStage
from mdvit_tpu.ops.layers import FastDropout
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops import layers as tl
from mdvit_tpu_torch.parallel.context import ContextMesh, _check_min_grid
from mdvit_tpu_torch.parallel.mesh import RowShard, row_sharded

torch.set_num_threads(2)

B, H, W, DIM, HEADS = 2, 16, 16, 64, 8


# ---------------------------------------------------------------- A and A′ split

# (B, N, C, ch, k scale), the row blocks' first rows: two halves, and three
# blocks, the last ragged against the chunk rows
SPLIT_CASES = [(2, 256, 64, 8, 1.0), (2, 700, 64, 8, 5.0), (2, 300, 128, 16, 5.0),
               (1, 200, 96, 12, 5.0), (2, 130, 152, 19, 5.0), (2, 100, 512, 64, 5.0)]


@pytest.mark.parametrize("blocks", [2, 3])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_split_plain_versions_match_whole_n(case, blocks):
    """Partials of each row block, concatenated a (b, h) in block order (the
    gather), then each block's apply: the whole N's forward and backward,
    within 4e-6 of each output's largest value. That is fp32 order noise: the
    chunked plain version on the whole N in one call (one block) differs from
    the einsum references by up to 1.6e-6 of the largest value at N = 700
    with k ×5."""
    b, n, c, ch, kscale = case
    rs = np.random.RandomState(n + ch)
    q, k, v, g = (torch.from_numpy(rs.standard_normal((b, n, c)).astype(np.float32))
                  for _ in range(4))
    k = k * kscale
    scale = ch ** -0.5
    cuts = [0, n // 2, n] if blocks == 2 else [0, n // 3, 2 * n // 3 + 1, n]
    rows = [slice(cuts[i], cuts[i + 1]) for i in range(blocks)]
    ws = torch.cat([fa.factorized_attention_partials_ref(k[:, r], v[:, r], ch) for r in rows], 1)
    assert ws.shape == (b * c // ch, sum(-(-(r.stop - r.start) // fa.chunk_rows(ch, False))
                                         for r in rows) * fa.partial_floats(ch, False))
    out = torch.cat([fa.factorized_attention_apply_ref(q[:, r], ws, ch, scale) for r in rows], 1)
    wsb = torch.cat([fa.factorized_attention_bwd_partials_ref(q[:, r], k[:, r], v[:, r],
                                                              g[:, r], ch) for r in rows], 1)
    grads = [torch.cat(d, 1) for d in zip(*[
        fa.factorized_attention_bwd_apply_ref(k[:, r], v[:, r], g[:, r], wsb, ch, scale)
        for r in rows])]
    want = [fa.factorized_attention_ref(q, k, v, ch, scale),
            *fa.factorized_attention_bwd_ref(q, k, v, g, ch, scale)]
    for got, ref in zip([out, *grads], want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=4e-6 * float(ref.abs().max()))


def test_split_ops_on_cpu_run_the_plain_versions():
    """The custom ops' CPU kernels are the plain versions, and their fakes give
    the workspace's shape."""
    rs = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rs.standard_normal((2, 40, 64)).astype(np.float32))
                  for _ in range(4))
    ws = torch.ops.mdvit.factorized_attention_partials(k, v, 8)
    torch.testing.assert_close(ws, fa.factorized_attention_partials_ref(k, v, 8), rtol=0, atol=0)
    out = torch.ops.mdvit.factorized_attention_apply(q, ws, 8, 0.5)
    torch.testing.assert_close(out, fa.factorized_attention_apply_ref(q, ws, 8, 0.5),
                               rtol=0, atol=0)
    wsb = torch.ops.mdvit.factorized_attention_bwd_partials(q, k, v, g, 8)
    dq, dk, dv = torch.ops.mdvit.factorized_attention_bwd_apply(k, v, g, wsb, 8, 0.5)
    for got, want in zip((dq, dk, dv), fa.factorized_attention_bwd_apply_ref(k, v, g, wsb, 8, 0.5)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fk = mode.from_tensor(k)
        assert torch.ops.mdvit.factorized_attention_partials(fk, fk, 8).shape == ws.shape
        assert torch.ops.mdvit.factorized_attention_bwd_partials(fk, fk, fk, fk, 8).shape \
            == wsb.shape


# ---------------------------------------------------------------- halo exchange


def test_halo_exchange_matches_zero_padding(tmp_path):
    """4 gloo ranks: each rank's extended rows are the zero-padded global rows
    around it, and the backward of Σ out·g is autograd's through the
    pad-and-slice of the global grid; a halo deeper than the local rows
    raises."""
    rs = np.random.RandomState(7)
    full = torch.from_numpy(rs.standard_normal((B, H, W, 3)).astype(np.float32))
    halo, n = 2, 4
    h_loc = H // n
    g = torch.from_numpy(rs.standard_normal((n, B, h_loc + 2 * halo, W, 3)).astype(np.float32))
    spec = tmp_path / "spec.pt"
    torch.save({"full": full, "halo": halo, "cotangent": g}, spec)
    res = torch_dp.spawn(torch_cp.halo_worker, n, tmp_path, str(spec), str(tmp_path / "out"))
    x = full.clone().requires_grad_()
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, halo, halo))
    total = sum((padded[:, r * h_loc:r * h_loc + h_loc + 2 * halo] * g[r]).sum() for r in range(n))
    (dx,) = torch.autograd.grad(total, x)
    for r in range(n):
        torch.testing.assert_close(res[r]["out"],
                                   padded.detach()[:, r * h_loc:r * h_loc + h_loc + 2 * halo],
                                   rtol=0, atol=0)
        torch.testing.assert_close(res[r]["dx"], dx[:, r * h_loc:(r + 1) * h_loc],
                                   rtol=1e-6, atol=1e-6)
        assert "exceeds" in res[r]["too_deep"]


# ---------------------------------------------------------------- the stage


def _jax_stage(sup: bool, dsn: bool, drop: float = 0.0, axis_name=None):
    return JaxMHSAStage(dim=DIM, num_layers=2, num_heads=HEADS, mlp_ratio=4.0, sup=sup,
                        dsn=dsn, num_domains=4, drop=drop, axis_name=axis_name)


def _carry(tree: dict) -> dict:
    """The port's names of a stage's flax leaves (the stage at stage 0)."""
    sd = from_jax_variables({"params": {"core": {"mhsa_stage0": tree}}})
    return {k[len("mhsa_stages.0."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("sup,dsn", [(True, True), (False, False)])
def test_stage_matches_jax_unsharded(tmp_path, sup, dsn, n):
    """The row-sharded stage on n gloo ranks against JAX's unsharded stage
    with the same weights: the output within 2e-5, the parameter gradients
    of Σ out·g within rtol 5e-4, atol 5e-5 (``test_context_parallel.py``)."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((B, H * W, DIM)).astype(np.float32)
    g = rs.standard_normal((B, H * W, DIM)).astype(np.float32)
    dom = np.eye(4, dtype=np.float32)[[1, 3]] if sup or dsn else None
    ref = _jax_stage(sup, dsn)
    params = jax.jit(lambda k: ref.init(k, x, (H, W), dom, False))(jax.random.PRNGKey(1))
    apply = jax.jit(lambda p: ref.apply(p, x, (H, W), dom, False))
    out_ref = apply(params)
    g_ref = jax.jit(jax.grad(lambda p: jnp.sum(apply(p) * g)))(params)
    spec = tmp_path / "spec.pt"
    torch.save({"stage": dict(dim=DIM, num_layers=2, num_heads=HEADS, mlp_ratio=4.0,
                              num_domains=4, sup=sup, dsn=dsn),
                "state_dict": _carry(jax.tree.map(np.asarray, params["params"])),
                "x": torch.from_numpy(x), "dom": None if dom is None else torch.from_numpy(dom),
                "cotangent": torch.from_numpy(g), "size": (H, W)}, spec)
    res = torch_dp.spawn(torch_cp.stage_worker, n, tmp_path, str(spec), str(tmp_path / "out"))
    want_grads = _carry(jax.tree.map(np.asarray, g_ref["params"]))
    for r in range(n):
        np.testing.assert_allclose(res[r]["out"].numpy(), np.asarray(out_ref),
                                   rtol=2e-5, atol=2e-5)
        assert set(res[r]["grads"]) == set(want_grads)
        for name, want in want_grads.items():
            np.testing.assert_allclose(res[r]["grads"][name].numpy(), want.numpy(),
                                       rtol=5e-4, atol=5e-5, err_msg=name)


def test_stage_dropout_masks_match_jax_shard_map():
    """Each of 4 shards' element dropout mask in ``"stage"`` mode (the shard
    index folded into the seed, local counters) against JAX's
    ``FastDropout(axis_name="ctx")`` under a 4-device ``shard_map``, both
    given the same seed; the shards' masks differ."""
    seed, n = 0x12345678, 4
    shape = (B, (H // n) * W, DIM)
    drop = FastDropout(0.5, axis_name="ctx")

    def local(xs, key):
        return drop.apply({}, xs, True, rngs={"dropout": key})

    mesh = Mesh(np.array(jax.devices()[:n]), ("ctx",))
    with mock.patch.object(jax.random, "bits", lambda *a, **k: jnp.uint32(seed)):
        masked = jax.shard_map(local, mesh=mesh, in_specs=(P(None, "ctx"), P()),
                               out_specs=P(None, "ctx"), check_vma=False)(
            jnp.ones((B, n * shape[1], DIM)), jax.random.PRNGKey(5))
    want = np.asarray(masked).reshape(B, n, *shape[1:]) != 0
    with mock.patch.object(tl, "draw_seed", lambda gen: seed):
        for r in range(n):
            with row_sharded(RowShard(None, r, n, "stage")):
                got = tl.fast_dropout(torch.ones(shape), 0.5, True, None) != 0
            np.testing.assert_array_equal(got.numpy(), want[:, r])
    assert not np.array_equal(want[:, 0], want[:, 1])


def test_even_rows_rule():
    """The even-rows rule is gone: JAX's guards alone remain. 96² over 2
    ranks (a 3-row deepest grid, 2 + 1) is accepted, 32² over 2 (a 1-row
    deepest grid) refused, and on a (data 2, ctx 2) grid the 1×1-tile rule
    refuses batch/data = 1 with deepest grid // ctx = 3 // 2 = 1."""
    mesh = ContextMesh(None, None, None, 0, 0, 2, 1)
    _check_min_grid(None, (1, 96, 96, 3), mesh)
    _check_min_grid(None, (1, 128, 128, 3), mesh)
    with pytest.raises(ValueError, match="ctx"):
        _check_min_grid(None, (1, 32, 32, 3), mesh)
    grid = ContextMesh(None, None, None, 0, 0, 2, 2, dp=True)
    _check_min_grid(None, (4, 96, 96, 3), grid)
    with pytest.raises(ValueError, match="DP x CP"):
        _check_min_grid(None, (2, 96, 96, 3), grid)
