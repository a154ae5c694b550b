"""The port's context parallelism on row blocks of unequal height, on the CPU:
the split plain versions of kernels A and A′ with unequal chunk counts a rank
(the missing chunks empty partials, also first in a rank's block), the
row-shard pieces on unequal blocks in gloo ranks (``tests/torch_cp.py``)
against the same ops on the whole grid, and JAX's tiny BASE+Sup
(``test_torch_context_parallel_e2e.py``'s widths) at 96² over 2 ranks
(deepest grid 3 rows: 2 + 1) and 160² over 4 (5 rows: 2 + 1 + 1 + 1): the
forward against the port's and JAX's unsharded forwards, the train-mode
forward and one train step against the port's unsharded ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_cp
import torch_dp
from mdvit_tpu.models.base import BASE as JaxBASE
from mdvit_tpu.train.losses import seg_loss_from_logits
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.ops import factorized_attention as fa
from mdvit_tpu_torch.ops import layers
from mdvit_tpu_torch.ops.layers import Conv2d
from mdvit_tpu_torch.ops.resize import resize_bilinear
from mdvit_tpu_torch.parallel.mesh import balanced_rows
from test_torch_context_parallel_e2e import (BN_TOL, FWD_TOL, LOSS_RTOL, TINY, _close,
                                             _grads_close, _step_close, _variables)

torch.set_num_threads(2)


# ---------------------------------------------------------------- A and A′ split

# (B, N, C, ch, k scale) and each rank's tokens: 2 chunks against 1, and 2
# against 1 against 1 with a one-token block
UNEVEN_CASES = [((2, 700, 64, 8, 5.0), (450, 250)), ((2, 430, 96, 12, 5.0), (300, 129, 1)),
                ((2, 150, 512, 64, 5.0), (100, 50))]


def _split_run(q, k, v, g, ch, tokens, where: str):
    """Each rank's forward and backward rows through the plain split
    versions, the workspaces padded with empty partials ``where`` ("last",
    "first") in a rank's block or concatenated unpadded ("none";
    ``torch_cp.padded_workspace``)."""
    scale = ch ** -0.5
    cuts = np.cumsum((0,) + tokens)
    rows = [slice(int(cuts[i]), int(cuts[i + 1])) for i in range(len(tokens))]

    def gathered(parts, grad):
        return torch_cp.padded_workspace(parts, tokens, ch, grad, where)

    ws = gathered([fa.factorized_attention_partials_ref(k[:, r], v[:, r], ch) for r in rows],
                  False)
    out = torch.cat([fa.factorized_attention_apply_ref(q[:, r], ws, ch, scale) for r in rows], 1)
    wsb = gathered([fa.factorized_attention_bwd_partials_ref(q[:, r], k[:, r], v[:, r],
                                                             g[:, r], ch) for r in rows], True)
    grads = [torch.cat(d, 1) for d in zip(*[
        fa.factorized_attention_bwd_apply_ref(k[:, r], v[:, r], g[:, r], wsb, ch, scale)
        for r in rows])]
    return ws, [out, *grads]


@pytest.mark.parametrize("front", [False, True], ids=["empty_last", "empty_first"])
@pytest.mark.parametrize("case", UNEVEN_CASES, ids=lambda c: "-".join(map(str, c[1])))
def test_split_plain_versions_with_unequal_chunks(case, front):
    """Ranks holding unequal token counts, each rank's workspace padded to the
    most chunks with empty partials (m = −∞, zero sums), the empty ones last
    or first in its block: each rank's apply folds the n·S_max partials.
    Against the same partials concatenated unpadded, within 1e-6 of each
    output's largest value (the padding adds zeros to the fold's sums, which
    may reorder them); against the whole N's forward and backward within
    6e-6 (the unpadded split alone reads up to 4.3e-6 here: fp32 order noise
    of other chunk boundaries, a one-token block, k ×5); all finite."""
    (b, n, c, ch, kscale), tokens = case
    assert sum(tokens) == n
    rs = np.random.RandomState(n + ch)
    q, k, v, g = (torch.from_numpy(rs.standard_normal((b, n, c)).astype(np.float32))
                  for _ in range(4))
    k = k * kscale
    ws, padded = _split_run(q, k, v, g, ch, tokens, "first" if front else "last")
    most = max(-(-t // fa.chunk_rows(ch, False)) for t in tokens)
    assert ws.shape[1] == len(tokens) * most * fa.partial_floats(ch, False)
    _, plain = _split_run(q, k, v, g, ch, tokens, "none")
    scale = ch ** -0.5
    want = [fa.factorized_attention_ref(q, k, v, ch, scale),
            *fa.factorized_attention_bwd_ref(q, k, v, g, ch, scale)]
    for got, unpadded, ref in zip(padded, plain, want):
        assert bool(torch.isfinite(got).all())
        top = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), unpadded.numpy(), rtol=0, atol=1e-6 * top)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=6e-6 * top)


def test_pad_partials_appends_empty_partials():
    """``pad_partials`` keeps a workspace's partials and appends empty ones:
    m = −∞ in the bucket's W columns, every other float 0; a workspace that
    has the chunks already is returned as it is."""
    k = torch.randn(2, 300, 64)
    ws = fa.factorized_attention_partials_ref(k, k, 8)
    p, s = fa.partial_floats(8, False), ws.shape[1] // fa.partial_floats(8, False)
    assert fa.pad_partials(ws, s, 8, False) is ws
    padded = fa.pad_partials(ws, s + 2, 8, False).reshape(ws.shape[0], s + 2, p)
    torch.testing.assert_close(padded[:, :s].reshape(ws.shape), ws, rtol=0, atol=0)
    assert bool((padded[:, s:, :8] == float("-inf")).all())
    assert bool((padded[:, s:, 8:] == 0).all())


# ---------------------------------------------------------------- unequal blocks

B, W, C = 2, 5, 3
ROWS, LEVEL, DEEP, SEED = (3, 2, 2), 2, 5, 0x2468ACE


def _references(full: torch.Tensor, conv: torch.nn.Module) -> dict:
    """name → (global function of the full grid, this output's level factor
    against the input's): each rank's output is the level's block of it."""
    h, w = full.shape[1], full.shape[2]
    return {"halo1": (lambda x: F.pad(x, (0, 0, 0, 0, 1, 1)), None),
            "halo_deep": (lambda x: F.pad(x, (0, 0, 0, 0, DEEP, DEEP)), None),
            "down": (lambda x: resize_bilinear(x, (h // 2, w)), 0.5),
            "up": (lambda x: resize_bilinear(x, (h * 2, w)), 2.0),
            "conv": (conv, 0.5)}


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("blocks")
    rs = np.random.RandomState(11)
    full = torch.from_numpy(rs.standard_normal((B, sum(ROWS) * LEVEL, W, C)).astype(np.float32))
    torch.manual_seed(5)
    conv = Conv2d(C, 4, 3, 2, 1)
    n = len(ROWS)
    starts = np.cumsum((0,) + tuple(r * LEVEL for r in ROWS))
    refs = _references(full, conv)
    outs = {}
    for name, (fn, factor) in refs.items():
        glob = fn(full)
        if factor is None:  # a halo: the rank's rows and `pad` more each side
            pad = (glob.shape[1] - full.shape[1]) // 2
            outs[name] = [glob[:, starts[r]:starts[r + 1] + 2 * pad] for r in range(n)]
        else:
            cut = [int(s * factor) for s in starts]
            outs[name] = [glob[:, cut[r]:cut[r + 1]] for r in range(n)]
    outs["gather"] = [full] * n
    outs["mean"] = [full.mean(dim=(1, 2))] * n
    outs["first"] = [full[:, 0]] * n
    cot = [{name: torch.from_numpy(rs.standard_normal(o[r].shape).astype(np.float32))
            for name, o in outs.items()} for r in range(n)]
    spec = tmp / "spec.pt"
    torch.save({"full": full, "rows": ROWS, "deep": DEEP, "seed": SEED, "cotangents": cot,
                "conv": conv.state_dict()}, spec)
    res = torch_dp.spawn(torch_cp.blocks_worker, n, tmp, str(spec), str(tmp / "out"))
    return full, conv, starts, outs, cot, res


def _want_grad(full, name, conv, cot, n):
    """The gradient of Σ_r ⟨rank r's output, its cotangent⟩ as a function of
    the whole grid: the rank pieces' backward adds every rank's pull."""
    x = full.clone().requires_grad_()
    if name == "mean":
        total = sum((x.mean(dim=(1, 2)) * cot[r]["mean"]).sum() for r in range(n))
    elif name == "first":
        total = sum((x[:, 0] * cot[r]["first"]).sum() for r in range(n))
    else:
        fn, factor = _references(full, conv)[name]
        glob = fn(x)
        starts = np.cumsum((0,) + tuple(r * LEVEL for r in ROWS))
        total = 0
        for r in range(n):
            if factor is None:
                pad = (glob.shape[1] - full.shape[1]) // 2
                piece = glob[:, starts[r]:starts[r + 1] + 2 * pad]
            else:
                piece = glob[:, int(starts[r] * factor):int(starts[r + 1] * factor)]
            total = total + (piece * cot[r][name]).sum()
    (dx,) = torch.autograd.grad(total, x)
    return dx


def test_unequal_blocks_split_and_start(blocks):
    """Each rank finds every rank's rows (6, 4, 4) and its first row from its
    own row count; ``balanced_rows`` gives the first ranks the extra rows."""
    _, _, starts, _, _, res = blocks
    assert balanced_rows(7, 3) == ROWS and balanced_rows(15, 2) == (8, 7)
    assert balanced_rows(14, 4) == (4, 4, 3, 3)
    for r, got in enumerate(res):
        assert got["split"] == tuple(x * LEVEL for x in ROWS)
        assert got["start"] == starts[r]


@pytest.mark.parametrize("name", ["halo1", "halo_deep", "gather", "mean", "down", "up", "conv",
                                  "first"])
def test_unequal_blocks_match_whole_grid(blocks, name):
    """3 gloo ranks holding 6, 4 and 4 rows of a 14-row grid: a 1-row halo
    (the neighbours'), a 5-row halo (past the 4-row ranks: the whole grid
    gathered), the gather, the spatial mean, resizes to 7 and 28 rows and a
    stride-2 3×3 conv against the same ops on the whole grid, forward
    (halos and gather bit-equal; the rest within 1e-6) and backward (the
    gather's backward keeps the rank's rows of its cotangent; the others add
    every rank's pull, within 1e-5)."""
    full, conv, starts, outs, cot, res = blocks
    n = len(ROWS)
    exact = name in ("halo1", "halo_deep", "gather", "first")
    for r in range(n):
        tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(res[r][name], outs[name][r].detach(), **tol)
    if name == "first":
        for r in range(n):
            torch.testing.assert_close(res[r]["first_poisoned"], full[:, 0], rtol=0, atol=0)
    if name == "gather":
        for r in range(n):
            torch.testing.assert_close(res[r]["d_gather"], cot[r]["gather"][:, starts[r]:starts[r + 1]],
                                       rtol=0, atol=0)
        return
    dx = _want_grad(full, name, conv, cot, n)
    for r in range(n):
        torch.testing.assert_close(res[r][f"d_{name}"], dx[:, starts[r]:starts[r + 1]],
                                   rtol=1e-5, atol=1e-5)


def test_unequal_blocks_dropout_masks_are_the_unsharded_rows(blocks, monkeypatch):
    """Each rank's ``"e2e"`` element mask is its rows of the unsharded mask
    drawn with the same seed."""
    full, _, starts, _, _, res = blocks
    monkeypatch.setattr(layers, "draw_seed", lambda gen: SEED)
    want = layers.fast_dropout(torch.ones_like(full), 0.5, True, None) != 0
    for r in range(len(ROWS)):
        torch.testing.assert_close(res[r]["mask"], want[:, starts[r]:starts[r + 1]])


# ---------------------------------------------------------------- BASE


def _base_spec(tmp_path, img: int, variables, x, y, dom) -> tuple[dict, str]:
    spec = {"model": dict(name="BASE", img_size=img, adapt_method="Sup", drop_rate=0.3,
                          drop_path_rate=0.3, **TINY),
            "state_dict": from_jax_variables(variables),
            "x": torch.from_numpy(x), "y": torch.from_numpy(y), "dom": torch.from_numpy(dom),
            "train_no_drop": True, "fp64_too": True}
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    return spec, str(path)


def _jax_step(model, variables, x, y, dom) -> dict:
    """``jax.value_and_grad`` of the unsharded single loss (BCE + dice from the
    train-mode logits, no dropout) at ``variables``: the loss, the gradients
    and the new BN stats in the port's names."""
    def loss_fn(params):
        out, mut = model.apply({**variables, "params": params}, x, dom, train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)},
                               mutable=["batch_stats"])
        return seg_loss_from_logits(out["seg"], jnp.asarray(y)), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    grads, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (grads, stats))
    return {"loss": np.asarray(loss), "grads": from_jax_variables({"params": grads}),
            "stats": from_jax_variables({"batch_stats": stats})}


@pytest.mark.parametrize("img,n", [(96, 2), (160, 4)])
def test_base_on_uneven_rows(tmp_path, img, n):
    """BASE+Sup with the rows over n ranks where no grid splits evenly: the
    eval forward's ``seg`` and ``feat`` against JAX's unsharded forward
    (``FWD_TOL`` of max(1, max|ref|): at these sizes the port's unsharded
    logits themselves sit 1.6e-3 (96²) and 2.9e-3 (160²) from JAX's near
    zero, at logits up to 621 and 1557, past ``FWD_TOL`` elementwise; JAX's
    own CP reads 7.9e-4 at 96² over 2); one CP train step without dropout
    against ``jax.grad`` of JAX's unsharded loss (loss, BN stats, the ranks'
    summed gradients ÷ n). Against the port's unsharded ones, in fp64
    (``torch_cp.fp64``: in fp32 the ranks' other order of the same sums moves
    a few logits near zero past ``FWD_TOL`` on some CPUs, 3 of 18,432 by up
    to 8.7e-4 at 96²): the eval forward, the train-mode forward (dropout and
    stochastic depth 0.3: the unsharded masks' rows) and one CP train step
    (loss, BN stats, gradients), at ``FWD_TOL`` and the step's tolerances,
    the maps and gradients also within ``torch_cp.FP64_L2_TOL`` relative
    L2."""
    model = JaxBASE(img_size=img, adapt="Sup", num_domains=4, **TINY)
    variables = _variables(model, 2)
    rs = np.random.RandomState(img)
    x = rs.standard_normal((2, img, img, 3)).astype(np.float32)
    y = (rs.rand(2, img, img, 1) > 0.5).astype(np.float32)
    dom = np.eye(4, dtype=np.float32)[[1, 3]]
    want = jax.jit(lambda v: model.apply(v, x, dom, train=False))(variables)
    jax_step = _jax_step(model, variables, x, y, dom)
    spec, path = _base_spec(tmp_path, img, variables, x, y, dom)
    res = torch_dp.spawn(torch_cp.e2e_worker, n, tmp_path, path, str(tmp_path / "out"))
    ref = torch_cp.fp64_forward_and_step(spec, None)
    for r in res:
        for key in ("seg", "feat"):
            top = max(1.0, float(np.abs(want[key]).max()))
            _close(r[key].numpy(), want[key], rtol=0, atol=FWD_TOL["atol"] * top)
        got = r["fp64"]
        for key in ("seg", "feat", "train_seg"):
            _close(got[key].numpy(), ref[key].numpy(), **FWD_TOL)
            assert torch_cp.rel_l2({key: got[key]}, {key: ref[key]}) <= torch_cp.FP64_L2_TOL
        _step_close(got, ref)
        _grads_close(got["grads"], ref["grads"])
        assert torch_cp.rel_l2(got["grads"], ref["grads"]) <= torch_cp.FP64_L2_TOL
        no_drop = r["no_drop"]
        _close(float(no_drop["loss"]), float(jax_step["loss"]), rtol=LOSS_RTOL)
        assert no_drop["stats"] and set(no_drop["stats"]) <= set(jax_step["stats"])
        for name, a in no_drop["stats"].items():
            _close(a.numpy(), jax_step["stats"][name].numpy(), err_msg=name, **BN_TOL)
        _grads_close(no_drop["grads"], jax_step["grads"])
