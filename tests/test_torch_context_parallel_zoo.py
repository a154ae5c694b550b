"""The port's context parallelism of the segmentation comparators (UTNet,
SwinUnet, SwinUNETR, TransFuse_S, TransFuse_S_adapt) on the CPU, in gloo
ranks (``tests/torch_cp.py``), against JAX's unsharded models with the same
seeded flax variables (``tests/torch_family.py``'s draws).

The models at ``tests/torch_zoo.py``'s tiny widths at 64² over 2 ranks (the
least H for which JAX's guard accepts 2), the Swins with two blocks in the
stages whose grid is larger than the window, so that the second shifts its
windows (the tiny configs' one block a stage never does): the eval
forward's maps and ``feat`` within 1e-4·max(1, max|ref|); for UTNet, SwinUnet and SwinUNETR one CP train step
without dropout against ``jax.value_and_grad`` of JAX's unsharded single
loss (the loss and BN stats at ``torch_family.LOSS_TOL``, the ranks'
summed gradients ÷ 2 by ``check_gradients``). SwinUnet with window 3 at 96²
splits the deepest grid 2 : 1 and its 24-row grid 16 : 8, off the windows.
UTNet's probability and projection dropout (0.1) against the port's
unsharded train-mode forward and step, both in fp64: the masks are the
unsharded rows. UTNet's data seed is one where its step gradient does not
sit on a kink within fp32 rounding's reach (the sensitivity test says which).
The row-shard pieces the comparators add, on blocks of 6, 4 and 4 rows in
3 ranks, against the same functions of the whole grid. The refusals are in
``test_torch_context_parallel_e2e.py::test_other_models_raise``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp
import torch_dp
from mdvit_tpu.models.swin_unet import SwinUnet as JaxSwinUnet
from mdvit_tpu.models.swin_unetr import SwinUNETR as JaxSwinUNETR
from mdvit_tpu.models.transfuse import TransFuse as JaxTransFuse
from mdvit_tpu.models.utnet import UTNet as JaxUTNet
from mdvit_tpu.train.losses import seg_loss_from_logits
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.models.utnet import RelativePositionBias
from mdvit_tpu_torch.ops import layers
from mdvit_tpu_torch.ops.resize import resize_bilinear_align_corners
from torch_family import LOSS_TOL, check_gradients, random_variables
from torch_zoo import UTNET, check_maps

torch.set_num_threads(2)

# two blocks a stage wherever a grid is larger than the window (the second
# block shifts); one where the grid is one window (no shift there)
SWIN = dict(embed_dim=8, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8), window=4,
            drop_path_rate=0.0)
SWIN_96 = dict(SWIN, depths=(2, 2, 2, 1), window=3)
SWINUNETR = dict(feature_size=4, depths=(2, 2, 2, 1), num_heads=(1, 2, 4, 8), window=4)
TRANSFUSE = dict(img_size=64, drop_rate=0.0)

# case id → (flax module, registry name, the port's builder keywords, img, step,
# the data's seed)
CASES = {
    "SwinUnet": (lambda: JaxSwinUnet(img_size=64, **SWIN), "SwinUnet",
                 dict(img_size=64, **SWIN), 64, True, 10),
    "SwinUnet_96_uneven": (lambda: JaxSwinUnet(img_size=96, **SWIN_96), "SwinUnet",
                           dict(img_size=96, **SWIN_96), 96, True, 11),
    "SwinUNETR": (lambda: JaxSwinUNETR(img_size=64, **SWINUNETR), "SwinUNETR",
                  dict(img_size=64, **SWINUNETR), 64, True, 12),
    # UTNet's step gradient at this tiny width sits near kinks (ReLU, max
    # pool) at some inputs, where any other fp32 order of the same sums (JAX's,
    # the ranks') moves it past check_gradients' reach; seed 14's input is not
    # one of them (test_utnet_step_sensitivity_at_the_data_seeds)
    "UTNet": (lambda: JaxUTNet(**UTNET), "UTNet", dict(img_size=64, **UTNET), 64, True, 14),
    "TransFuse_S": (lambda: JaxTransFuse(img_size=64, variant="S", drop_rate=0.0),
                    "TransFuse_S", TRANSFUSE, 64, False, 15),
    "TransFuse_S_adapt": (lambda: JaxTransFuse(img_size=64, variant="S", sup=True,
                                               drop_rate=0.0),
                          "TransFuse_S_adapt", TRANSFUSE, 64, False, 16),
}
DROP = 0.1  # UTNet's default attention and projection dropout


def _data(img: int, seed: int):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((2, img, img, 3)).astype(np.float32)
    y = (rs.rand(2, img, img, 1) > 0.5).astype(np.float32)
    return x, y, np.eye(4, dtype=np.float32)[[1, 3]]


def _jax_step(model, variables, x, y, dom) -> dict:
    """``jax.value_and_grad`` of the unsharded single loss (BCE + dice of the
    train-mode logits, no dropout) at ``variables``: the loss, the
    gradients and the new BN stats in the port's names."""
    def loss_fn(params):
        out, mut = model.apply({**variables, "params": params}, x, dom, train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)},
                               mutable=["batch_stats"])
        return seg_loss_from_logits(out["seg"], jnp.asarray(y)), mut.get("batch_stats", {})

    with jax.default_matmul_precision("highest"):
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    grads, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (grads, stats))
    return {"loss": np.asarray(loss), "grads": from_jax_variables({"params": grads}),
            "stats": from_jax_variables({"batch_stats": stats}) if stats else {}}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """Every case's flax module, variables and data, and what 2 gloo ranks
    computed of it (one spawn); the dropout case's spec beside it."""
    tmp = tmp_path_factory.mktemp("zoo")
    jax_side, cases = {}, {}
    for cid, (make, name, kw, img, step, seed) in CASES.items():
        model = make()
        x, y, dom = _data(img, seed)
        variables = random_variables(model, jnp.zeros((2, img, img, 3)), jnp.asarray(dom),
                                     call_kw={"train": False})
        variables = {"batch_stats": {}, **variables}
        port = build_model(name, device="cpu", **kw)
        jax_side[cid] = (model, variables, x, y, dom)
        cases[cid] = {"model": dict(name=name, **kw),
                      "state_dict": from_jax_variables(variables, port),
                      "x": torch.from_numpy(x), "y": torch.from_numpy(y),
                      "dom": torch.from_numpy(dom), "train": step}
    drop = dict(cases["UTNet"], model=dict(cases["UTNet"]["model"], attn_drop=DROP,
                                           proj_drop=DROP), train_forward=True, fp64=True)
    cases["UTNet_dropout"] = drop
    spec = tmp / "spec.pt"
    torch.save({"cases": cases}, spec)
    res = torch_dp.spawn(torch_cp.zoo_worker, 2, tmp, str(spec), str(tmp / "out"))
    return jax_side, cases, res


@pytest.mark.parametrize("cid", list(CASES))
def test_forward_on_two_ranks_matches_jax(zoo, cid):
    """The eval forward's maps (TransFuse: all three) and ``feat`` on each
    rank within 1e-4·max(1, max|ref|) of JAX's unsharded forward."""
    jax_side, _, res = zoo
    model, variables, x, _, dom = jax_side[cid]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v: model.apply(v, x, dom, train=False))(variables)
    seg = want["seg"]
    want_maps = [np.asarray(m) for m in (seg if isinstance(seg, tuple) else (seg,))]
    for r in res:
        got = r[cid]["seg"]
        got = [m.numpy() for m in (got if isinstance(got, tuple) else (got,))]
        check_maps(want_maps, got)
        check_maps([np.asarray(want["feat"])], [r[cid]["feat"].numpy()])


@pytest.mark.parametrize("cid", [c for c, spec in CASES.items() if spec[4]])
def test_step_on_two_ranks_matches_jax(zoo, cid):
    """One CP train step without dropout against ``jax.value_and_grad`` of
    JAX's unsharded loss: the loss and BN running stats (UTNet's; the Swins
    have none) at ``LOSS_TOL``, the ranks' summed gradients ÷ 2 at
    ``check_gradients``' tolerance."""
    jax_side, _, res = zoo
    want = _jax_step(*jax_side[cid])
    for r in res:
        got = r[cid]
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **LOSS_TOL)
        assert set(got["stats"]) == set(want["stats"])
        for name, a in want["stats"].items():
            np.testing.assert_allclose(got["stats"][name].numpy(), a.numpy(), err_msg=name,
                                       **LOSS_TOL)
        check_gradients(want, got["grads"])


def test_utnet_dropout_masks_are_the_unsharded_rows(zoo):
    """UTNet with attention-probability and projection dropout 0.1: the
    train-mode forward and one CP step against the port's unsharded ones
    from the same generator seeds (the probabilities' tokens on axis 2 hash
    the unsharded tensor's counters), both in fp64 (``torch_cp.fp64``: in
    fp32 the ranks' other order of the same sums moves this step's gradient
    past ``check_gradients`` on some CPUs, ``inc0.bn1.weight`` by 4e-4 of a
    largest 0.062, where the sensitivity test finds a kink within 1e-7 of
    the input): maps within 1e-5·max(1, max|ref|), the loss and BN stats at
    ``LOSS_TOL``, gradients by ``check_gradients`` and within
    ``torch_cp.FP64_L2_TOL`` relative L2. The same step without dropout
    differs (the masks act)."""
    jax_side, cases, res = zoo
    spec = cases["UTNet_dropout"]
    ref = {**torch_cp.forwards(spec, None), **torch_cp.train_step(spec, None)}
    for r in res:
        got = r["UTNet_dropout"]
        scale = max(1.0, float(ref["train_seg"].abs().max()))
        np.testing.assert_allclose(got["train_seg"].numpy(), ref["train_seg"].numpy(), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), **LOSS_TOL)
        for name, a in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][name].numpy(), a.numpy(), err_msg=name,
                                       **LOSS_TOL)
        check_gradients(ref, got["grads"])
        assert torch_cp.rel_l2(got["grads"], ref["grads"]) <= torch_cp.FP64_L2_TOL
        assert abs(float(got["loss"]) - float(r["UTNet"]["loss"])) > 1e-4


@pytest.mark.parametrize("seed,low,high", [(13, 1e-3, 1.0), (14, 0.0, 1e-4)])
def test_utnet_step_sensitivity_at_the_data_seeds(seed, low, high):
    """Why UTNet's cases take data seed 14: the port's unsharded step
    gradient has a kink (a ReLU or max-pool decision on the edge) within
    1e-7 of the input at seed 13, and none at seed 14. Measured in fp64
    (``torch_cp.fp64``), where rounding is far below the move, so the
    reading does not depend on the CPU's vector width: the second
    difference g(x + εn) + g(x − εn) − 2·g(x), ε = 1e-7, relative L2, is
    above 1e-3 at seed 13 (a jump: within fp32 rounding's reach, past
    ``check_gradients``' for two fp32 orders of the same sums) and below
    1e-4 at seed 14 (smooth: O(ε²))."""
    make, name, kw, img, _, _ = CASES["UTNet"]
    model = make()
    x, y, dom = _data(img, seed)
    variables = random_variables(model, jnp.zeros((2, img, img, 3)), jnp.asarray(dom),
                                 call_kw={"train": False})
    case = {"model": dict(name=name, **kw), "y": torch.from_numpy(y),
            "dom": torch.from_numpy(dom), "fp64": True,
            "state_dict": from_jax_variables({"batch_stats": {}, **variables},
                                             build_model(name, device="cpu", **kw))}
    x64 = x.astype(np.float64)
    move = 1e-7 * np.random.RandomState(0).standard_normal(x.shape)
    g0, up, down = (torch_cp.train_step(dict(case, x=torch.from_numpy(xi)), None)["grads"]
                    for xi in (x64, x64 + move, x64 - move))
    # ‖(up + down − g0) − g0‖ / ‖g0‖
    shift = torch_cp.rel_l2({n: up[n] + down[n] - g for n, g in g0.items()}, g0)
    assert low < shift < high, shift


# ---------------------------------------------------------------- row-shard pieces

B, W, C = 2, 6, 3
ROWS, LEVEL, SEED, REDUCE, HEAD = (3, 2, 2), 2, 0x13579B, 3, 37
# each rank's (lo, hi) of the 14-row grid, blocks [0, 6), [6, 10), [10, 14):
# within the neighbours' blocks, the first and last wrapping cyclically; and
# reaching past them (rank 0 five rows above, rank 2 six past the end)
RANGES = {"neighbours": ((-2, 8), (4, 12), (9, 16)), "grid": ((-5, 6), (6, 10), (10, 20))}


def _functions() -> dict:
    """name → the whole-grid function each rank's output is (a block of)."""
    h = sum(ROWS) * LEVEL
    return {
        "shared": lambda x: x,
        "moments": lambda x: torch.cat([x.mean(dim=(1, 2), keepdim=True), (
            x - x.mean(dim=(1, 2), keepdim=True)).square().mean(dim=(1, 2), keepdim=True)], -1),
        "ac_up": lambda x: resize_bilinear_align_corners(x, (2 * h, W)),
        "ac_head": lambda x: resize_bilinear_align_corners(x, (HEAD * sum(ROWS), W)),
        "ac_whole": lambda x: resize_bilinear_align_corners(x, (REDUCE, REDUCE)),
        "ac_whole_same": lambda x: resize_bilinear_align_corners(x, (h, REDUCE))}


def _out(name: str, x: torch.Tensor, r: int) -> torch.Tensor:
    """Rank ``r``'s output of ``name`` as a function of the whole grid ``x``:
    its cyclic range, the whole result, or its block of the result's rows
    (the row split scaled to the result's height)."""
    if name.startswith("cyclic_"):
        lo, hi = RANGES[name[len("cyclic_"):]][r]
        return x[:, [p % x.shape[1] for p in range(lo, hi)]]
    glob = _functions()[name](x)
    if name not in ("ac_up", "ac_head"):
        return glob
    per = glob.shape[1] // sum(ROWS)  # the result's rows a deepest row
    cut = np.cumsum((0,) + tuple(per * n for n in ROWS))
    return glob[:, int(cut[r]):int(cut[r + 1])]


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pieces")
    rs = np.random.RandomState(12)
    full = torch.from_numpy(rs.standard_normal((B, sum(ROWS) * LEVEL, W, C)).astype(np.float32))
    starts = np.cumsum((0,) + tuple(n * LEVEL for n in ROWS))
    names = [f"cyclic_{k}" for k in RANGES] + ["shared", "moments", "ac_up", "ac_head",
                                                "ac_whole", "ac_whole_same"]
    outs = {name: [_out(name, full, r) for r in range(len(ROWS))] for name in names}
    cot = [{name: torch.from_numpy(rs.standard_normal(o[r].shape).astype(np.float32))
            for name, o in outs.items()} for r in range(len(ROWS))]
    spec = tmp / "spec.pt"
    torch.save({"full": full, "rows": ROWS, "ranges": RANGES, "seed": SEED, "reduce": REDUCE,
                "head": HEAD * sum(ROWS), "cotangents": cot}, spec)
    res = torch_dp.spawn(torch_cp.zoo_blocks_worker, len(ROWS), tmp, str(spec),
                         str(tmp / "out"))
    return full, starts, outs, cot, res


@pytest.mark.parametrize("name", ["cyclic_neighbours", "cyclic_grid", "shared", "moments",
                                  "ac_up", "ac_head", "ac_whole", "ac_whole_same"])
def test_row_shard_pieces_match_whole_grid(pieces, name):
    """3 gloo ranks holding 6, 4 and 4 rows of a 14-row grid: ``cyclic_rows``
    of ranges within the neighbours' blocks (wrapping from the last rank to
    the first and back) and of ranges reaching past them, the gathered
    whole (``gather_shared_rows``), InstanceNorm's two-pass moments, the
    align-corners resize on row blocks to 28 and 259 rows, and
    ``resize_ac_whole`` to 3 rows and to the grid's own 14 (an identity
    row matrix: each rank's rows, summed):
    forward against the same function of the whole grid (the row moves
    bit-equal, the rest within 1e-6), backward against autograd of
    Σ_r ⟨rank r's output, its cotangent⟩ through the whole grid (each
    row's gradient added from every rank that used it; within 1e-5)."""
    full, starts, outs, cot, res = pieces
    n = len(ROWS)
    exact = name in ("cyclic_neighbours", "cyclic_grid", "shared")
    for r in range(n):
        tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(res[r][name], outs[name][r], **tol)
    x = full.clone().requires_grad_()
    total = sum((_out(name, x, r) * cot[r][name]).sum() for r in range(n))
    (dx,) = torch.autograd.grad(total, x)
    for r in range(n):
        torch.testing.assert_close(res[r][f"d_{name}"], dx[:, starts[r]:starts[r + 1]],
                                   rtol=1e-5, atol=1e-5)


def test_dropout_on_a_token_axis_is_the_unsharded_rows(pieces, monkeypatch):
    """An element mask of (B, 3, tokens, 5) with the tokens row-sharded on
    axis 2 (``row_axis=2``): each rank's mask is its tokens of the
    unsharded mask drawn with the same seed."""
    full, starts, _, _, res = pieces
    monkeypatch.setattr(layers, "draw_seed", lambda gen: SEED)
    tokens = torch.ones(B, 3, full.shape[1] * W, 5)
    want = layers.fast_dropout(tokens, 0.5, True, None, row_axis=2) != 0
    for r in range(len(ROWS)):
        torch.testing.assert_close(res[r]["mask"], want[:, :, starts[r] * W:starts[r + 1] * W])


@pytest.mark.parametrize("start,hq", [(0, 16), (16, 16), (5, 11), (12, 9)])
def test_relative_position_bias_rows(start, hq):
    """UTNet's bias of query rows [start, start + hq) of a 32-row grid (reduce
    size 4: 8 query rows a reduced row; blocks on and off those cells) is
    those rows of the whole grid's bias."""
    torch.manual_seed(0)
    bias = RelativePositionBias(2, 4)
    bias.init_from(torch.Generator().manual_seed(1))
    whole = bias(32, 8).reshape(2, 32, 8, 16)
    got = bias(hq, 8, start, 32)
    torch.testing.assert_close(got, whole[:, start:start + hq].reshape(2, hq * 8, 16),
                               rtol=0, atol=0)
