"""The port's context parallelism at image heights that are no multiple of
the stride to the deepest grid, on the CPU: the row split alone
(``row_split``: every grid's rows a rank from the model's chain of
row-changing ops), the row-shard pieces on ragged blocks in gloo ranks
(``tests/torch_cp.py``) against the same ops on the whole grid, JAX's tiny
BASE+Sup (``test_torch_context_parallel_e2e.py``'s widths) at 100² over 2
and 3 ranks against JAX's unsharded forward and ``jax.value_and_grad`` of
its unsharded loss, and the refusals where JAX's own unsharded forward has
no form at the height. MDViT's debranches, MPViT, CoaT and the (data, ctx)
grid at 100² are in ``test_torch_context_parallel_ragged_models.py``."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_cp
import torch_dp
import torch_zoo
from mdvit_tpu.models.base import BASE as JaxBASE
from mdvit_tpu.models.swin_unet import SwinUnet as JaxSwinUnet
from mdvit_tpu.models.swin_unetr import SwinUNETR as JaxSwinUNETR
from mdvit_tpu.models.transfuse import TransFuse as JaxTransFuse
from mdvit_tpu.models.utnet import UTNet as JaxUTNet
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.base import FATEncoderDecoder
from mdvit_tpu_torch.models.coat import CoaT
from mdvit_tpu_torch.models.mpvit import MPViT
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.ops import layers
from mdvit_tpu_torch.ops.layers import Conv2d
from mdvit_tpu_torch.ops.resize import resize_bilinear
from mdvit_tpu_torch.parallel.context import model_apply_context_parallel
from mdvit_tpu_torch.parallel.mesh import balanced_rows, chain_sizes, row_split
from test_torch_classifiers import COAT, MPVIT
from test_torch_context_parallel_e2e import (BN_TOL, FWD_TOL, LOSS_RTOL, TINY, _close,
                                             _grads_close, _variables)
from test_torch_context_parallel_uneven import _jax_step

torch.set_num_threads(2)

IMG = 100
CHAINS = {"BASE": FATEncoderDecoder.row_chain, "MPViT": MPViT.row_chain,
          "CoaT": CoaT.row_chain}


# ---------------------------------------------------------------- the split alone


def _grid_splits(h: int, n: int, chain) -> list:
    units, grids = row_split(h, h + 3, n, chain, 32)
    return units, [(height, split) for height, _, split in grids]


@pytest.mark.parametrize("model,n", [("BASE", 2), ("BASE", 3), ("CoaT", 2), ("MPViT", 2)])
def test_row_split_at_a_ragged_height(model, n):
    """At 100²: every grid's rows sum to its height (the chain's ⌈R/s⌉ or
    ⌊R/s⌋), no rank is empty, every rank boundary is a multiple of the
    stride of the op that leaves the grid and every rank's rows of the next
    grid are that op's output rows of its own; the deepest split makes the
    largest block of input rows the smallest any split of the deepest rows
    into n positive shares gives (all of them enumerated); BASE over 2 and
    3 ranks splits as the module docstring of ``parallel/context.py`` says."""
    chain = CHAINS[model]
    units, grids = _grid_splits(IMG, n, chain)
    assert [height for height, _ in grids] == chain_sizes(IMG, chain)
    assert len(units) == n and min(units) >= 1 and sum(units) == grids[-1][0]
    for (height, split), (kind, s), (_, nxt) in zip(grids, chain, grids[1:]):
        assert sum(split) == height and min(split) >= 1
        starts = np.cumsum((0,) + split)[:-1]
        assert all(int(b) % s == 0 for b in starts)
        down = (lambda r: -(-r // s)) if kind == "same" else (lambda r: r // s)
        assert tuple(down(r) for r in split) == nxt
    deep = grids[-1][0]
    t = 32
    best = min(max(max(t * u for u in c[:-1]), IMG - t * sum(c[:-1]))
               for c in itertools.product(range(1, deep + 1), repeat=n) if sum(c) == deep)
    assert max(grids[0][1]) == best
    if model == "BASE":
        want = {2: [(64, 36), (32, 18), (16, 9), (8, 5), (4, 3), (2, 2)],
                3: [(32, 32, 36), (16, 16, 18), (8, 8, 9), (4, 4, 5), (2, 2, 3), (1, 1, 2)]}
        assert [split for _, split in grids] == want[n]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_row_split_at_multiples_of_the_stride_is_balanced_rows(n):
    """At H a multiple of 32 the deepest split is ``balanced_rows`` and every
    grid's split that split scaled by its stride, for both kinds of chain;
    the ragged sizes of the card's cp phase split as its records say."""
    for chain in (CHAINS["BASE"], CHAINS["CoaT"]):
        for img in range(32 * n, 32 * n + 32 * 12, 32):
            units, grids = _grid_splits(img, n, chain)
            assert units == balanced_rows(img // 32, n)
            for height, split in grids:
                assert split == tuple(height // sum(units) * u for u in units)
    if n == 2:
        assert _grid_splits(470, 2, CHAINS["BASE"])[0] == (7, 8)
        assert _grid_splits(470, 2, CHAINS["BASE"])[1][0][1] == (224, 246)
        assert _grid_splits(230, 2, CHAINS["CoaT"])[1][0][1] == (128, 102)
    if n == 4:
        units, grids = _grid_splits(452, 4, CHAINS["BASE"])
        assert units == (4, 4, 4, 3) and grids[0][1] == (128, 128, 128, 68)


@pytest.mark.parametrize("model", ["BASE", "MPViT", "CoaT"])
def test_row_chain_lists_the_models_grids(model):
    """The chain's heights are the heights of every conv output of the
    port's unsharded model at 100² (tiny widths): no grid off the table."""
    if model == "BASE":
        net = build_model("BASE", img_size=IMG, device="cpu", **TINY)
    elif model == "MPViT":
        net = MPViT(**MPVIT)
    else:
        net = CoaT(**COAT)
    heights = set()
    for mod in net.modules():
        if isinstance(mod, Conv2d):
            mod.register_forward_hook(lambda m, a, out: heights.add(out.shape[1]))
    x = torch.zeros(1, IMG, IMG, 3)
    with torch.no_grad():
        net.eval()(x, torch.eye(4)[:1]) if model == "BASE" else net.eval()(x)
    assert heights and heights <= set(chain_sizes(IMG, CHAINS[model]))


# ---------------------------------------------------------------- ragged blocks

B, C, SEED = 2, 3, 0x13579BD
GRIDS, CONV_IN, RESIZES = (25, 13, 7, 4), 25, (4, 7, 13, 25)


def _rank_rows(n: int) -> dict:
    """height → each rank's (start, rows) of BASE's grids at 100² over n."""
    _, grids = _grid_splits(IMG, n, CHAINS["BASE"])
    out = {}
    for height, split in grids:
        starts = np.cumsum((0,) + split)[:-1]
        out[height] = [(int(s), r) for s, r in zip(starts, split)]
    return out


def _pieces(full: dict, conv) -> dict:
    """name → (input grid height, output grid height or None for the halo,
    the piece's function of the whole input grid)."""
    out = {"conv": (CONV_IN, 13, conv),
           "halo3": (4, None, lambda x: F.pad(x, (0, 0, 0, 0, 3, 3)))}
    for lo, hi in zip(RESIZES, RESIZES[1:]):
        out[f"resize_{lo}_{hi}"] = (lo, hi, lambda x, hi=hi: resize_bilinear(x, (hi, hi)))
    return out


def _cut(t, rows, height_out, r):
    if height_out is None:  # the halo: the rank's rows and 3 more each side
        s, n = rows[4][r]
        return t[:, s:s + n + 6]
    s, n = rows[height_out][r]
    return t[:, s:s + n]


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def ragged(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"ragged{n}")
    rs = np.random.RandomState(17)
    full = {h: torch.from_numpy(rs.standard_normal((B, h, h, C)).astype(np.float32))
            for h in GRIDS}
    torch.manual_seed(6)
    conv = Conv2d(C, 4, 3, 2, 1)
    rows = _rank_rows(n)
    want = {name: [_cut(fn(full[hin]).detach(), rows, hout, r) for r in range(n)]
            for name, (hin, hout, fn) in _pieces(full, conv).items()}
    cot = [{name: torch.from_numpy(rs.standard_normal(o[r].shape).astype(np.float32))
            for name, o in want.items()} for r in range(n)]
    spec = tmp / "spec.pt"
    torch.save({"img": IMG, "grids": full, "conv_in": CONV_IN, "resizes": RESIZES,
                "seed": SEED, "cotangents": cot, "conv": conv.state_dict()}, spec)
    res = torch_dp.spawn(torch_cp.ragged_blocks_worker, n, tmp, str(spec), str(tmp / "out"))
    return n, full, conv, rows, want, cot, res


def test_ragged_blocks_split_and_start(ragged):
    """Each rank finds every grid's split and its first row from the rows it
    holds, including the deepest grid's 1-row blocks over 3 ranks."""
    n, _, _, rows, _, _, res = ragged
    for r, got in enumerate(res):
        for height in GRIDS:
            assert got["split"][height] == tuple(k for _, k in rows[height])
            assert got["start"][height] == rows[height][r][0]


@pytest.mark.parametrize("name", ["conv", "halo3", "resize_4_7", "resize_7_13",
                                  "resize_13_25"])
def test_ragged_blocks_match_whole_grid(ragged, name):
    """The SAME stride-2 3×3 conv from the 25-row grid to the 13-row one
    (16 : 9 → 8 : 5 over 2 ranks, 8 : 8 : 9 → 4 : 4 : 5 over 3), a 3-row halo
    of the 4-row deepest grid (2 : 2; 1 : 1 : 2, the halo reaching past a
    1-row neighbour) and the resizes 4 → 7 → 13 → 25 on each rank's ragged
    block, against the same ops on the whole grid: forward (the halo
    bit-equal, the rest within 1e-6) and backward (every rank's pull added,
    within 1e-5)."""
    n, full, conv, rows, want, cot, res = ragged
    hin, hout, fn = _pieces(full, conv)[name]
    tol = dict(rtol=0, atol=0) if name == "halo3" else dict(rtol=1e-6, atol=1e-6)
    for r in range(n):
        torch.testing.assert_close(res[r][name], want[name][r], **tol)
    x = full[hin].clone().requires_grad_()
    glob = fn(x)
    total = sum((_cut(glob, rows, hout, r) * cot[r][name]).sum() for r in range(n))
    (dx,) = torch.autograd.grad(total, x)
    for r in range(n):
        s, k = rows[hin][r]
        torch.testing.assert_close(res[r][f"d_{name}"], dx[:, s:s + k], rtol=1e-5, atol=1e-5)


def test_ragged_blocks_dropout_masks_are_the_unsharded_rows(ragged, monkeypatch):
    """Each rank's ``"e2e"`` element masks of the 25-row grid, as (B, h, W, C)
    rows and as (B, h·W, C) tokens, are its rows of the unsharded masks
    drawn with the same seed."""
    n, full, _, rows, _, _, res = ragged
    monkeypatch.setattr(layers, "draw_seed", lambda gen: SEED)
    grid = torch.ones_like(full[CONV_IN])
    want_rows = layers.fast_dropout(grid, 0.5, True, None) != 0
    want_tokens = layers.fast_dropout(grid.flatten(1, 2), 0.5, True, None) != 0
    for r in range(n):
        s, k = rows[CONV_IN][r]
        torch.testing.assert_close(res[r]["mask_rows"], want_rows[:, s:s + k])
        torch.testing.assert_close(res[r]["mask_tokens"],
                                   want_tokens[:, s * CONV_IN:(s + k) * CONV_IN])


# ---------------------------------------------------------------- BASE at 100²


@pytest.fixture(scope="module")
def base_jax():
    """JAX's tiny BASE+Sup at 100²: its seeded variables, a batch of 2, the
    unsharded eval forward and ``jax.value_and_grad`` of the unsharded loss
    without dropout."""
    model = JaxBASE(img_size=IMG, adapt="Sup", num_domains=4, **TINY)
    variables = _variables(model, 2)
    rs = np.random.RandomState(IMG)
    x = rs.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    y = (rs.rand(2, IMG, IMG, 1) > 0.5).astype(np.float32)
    dom = np.eye(4, dtype=np.float32)[[1, 3]]
    want = jax.jit(lambda v: model.apply(v, x, dom, train=False))(variables)
    return variables, x, y, dom, want, _jax_step(model, variables, x, y, dom)


@pytest.mark.parametrize("n", [2, 3])
def test_base_at_a_ragged_height(tmp_path, base_jax, n):
    """BASE+Sup at 100² over n ranks (grids 100, 50, 25, 13, 7, 4 split as
    ``test_row_split_at_a_ragged_height`` says): the eval forward's ``seg``
    and ``feat`` against JAX's unsharded forward within ``FWD_TOL`` of
    max(1, max|ref|); the train-mode forward (dropout and stochastic depth
    0.3: the unsharded masks' rows) against the port's unsharded one; one
    CP train step without dropout against ``jax.value_and_grad`` of JAX's
    unsharded loss (loss, BN stats, the ranks' gradients)."""
    variables, x, y, dom, want, jax_step = base_jax
    spec = {"model": dict(name="BASE", img_size=IMG, adapt_method="Sup", drop_rate=0.3,
                          drop_path_rate=0.3, **TINY),
            "state_dict": from_jax_variables(variables), "x": torch.from_numpy(x),
            "y": torch.from_numpy(y), "dom": torch.from_numpy(dom), "train_forward": True,
            "train_no_drop": True}
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    res = torch_dp.spawn(torch_cp.e2e_worker, n, tmp_path, str(path), str(tmp_path / "out"))
    ref = torch_cp.forwards(spec, None)
    for r in res:
        for key in ("seg", "feat"):
            top = max(1.0, float(np.abs(want[key]).max()))
            _close(r[key].numpy(), want[key], rtol=0, atol=FWD_TOL["atol"] * top)
        _close(r["train_seg"].numpy(), ref["train_seg"].numpy(), **FWD_TOL)
        step = r["no_drop"]
        _close(float(step["loss"]), float(jax_step["loss"]), rtol=LOSS_RTOL)
        assert step["stats"] and set(step["stats"]) <= set(jax_step["stats"])
        for name, a in step["stats"].items():
            _close(a.numpy(), jax_step["stats"][name].numpy(), err_msg=name, **BN_TOL)
        _grads_close(step["grads"], jax_step["grads"])


# ---------------------------------------------------------------- refusals


def _jax_comparator(cid: str):
    """``torch_zoo.CASES``' flax module of ``cid`` at 100²."""
    if cid == "UTNet":
        return JaxUTNet(**torch_zoo.UTNET)
    if cid == "SwinUnet":
        return JaxSwinUnet(**{**torch_zoo.SWIN, "img_size": IMG})
    if cid == "SwinUNETR":
        return JaxSwinUNETR(**{**torch_zoo.SWINUNETR, "img_size": IMG})
    return JaxTransFuse(img_size=IMG, variant="S", drop_rate=0.0)


@pytest.mark.parametrize("cid", ["UTNet", "SwinUnet", "SwinUNETR", "TransFuse_S"])
def test_refused_where_jax_has_no_forward(cid):
    """At 100², which JAX's guard accepts over 2 ranks (100 // 32 ≥ 2), JAX's
    own unsharded forward of the comparators fails (its init, which traces
    the forward, raises a shape error), and the port refuses
    their context parallelism before any collective with a ``ValueError``
    naming the model, H and its height rule (a multiple of 16 for UTNet and
    TransFuse, of 32 for SwinUnet and SwinUNETR)."""
    _, name, kw, _ = torch_zoo.CASES[cid]
    kw = {**kw, "img_size": IMG} if "img_size" in kw else kw
    model = _jax_comparator(cid)
    x = jnp.zeros((1, IMG, IMG, 3))
    oh = jnp.eye(4, dtype=jnp.float32)[:1]
    with pytest.raises(TypeError, match="reshape|incompatible shapes"):
        jax.eval_shape(lambda k: model.init({"params": k, "dropout": k}, x, oh, train=False),
                       jax.random.PRNGKey(0))
    port = build_model(name, num_domains=4, device="cpu", **kw)
    unit = 16 if cid in ("UTNet", "TransFuse_S") else 32
    with pytest.raises(ValueError, match=f"{type(port).__name__}.*multiple of {unit}.*H={IMG}"):
        model_apply_context_parallel(port, torch.zeros(2, IMG, IMG, 3), torch.eye(4)[:2], None)
