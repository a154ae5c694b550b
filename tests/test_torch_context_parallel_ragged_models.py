"""The port's end-to-end context parallelism at 100², no multiple of the
stride to the deepest grid, on the CPU, in gloo ranks (``tests/torch_cp.py``)
against JAX's unsharded models with the same seeded flax variables: MDViT
with each of its four debranches (``test_torch_context_parallel_e2e.py``'s
tiny widths; B = 4, the rows over 2 ranks: every grid splits 64 : 36,
32 : 18, 16 : 9, 8 : 5, 4 : 3, 2 : 2, the MLPFM and MLP debranches' H/4
grid and the final resizes to H as the encoder grids of those heights),
and BASE+Sup on a (data 2, ctx 2) grid at B = 4: the forward and one train
step against JAX's unsharded forward and ``jax.value_and_grad`` of its
unsharded loss. The classifiers at 100² are in
``test_torch_context_parallel_ragged_classifiers.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp
import torch_dp
from mdvit_tpu.models.base import BASE as JaxBASE
from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.base import split_seg
from mdvit_tpu_torch.models.mdvit import DECODERS
from test_torch_context_parallel_e2e import (BN_TOL, FWD_TOL, LOSS_RTOL, TINY, _close,
                                             _grads_close, _variables)
from test_torch_context_parallel_uneven import _jax_step
from torch_family import random_variables

torch.set_num_threads(2)

IMG = 100


def _close_to(got, ref) -> None:
    """Within ``FWD_TOL``'s atol of max(1, max|ref|)."""
    ref = np.asarray(ref)
    _close(got.numpy(), ref, rtol=0, atol=FWD_TOL["atol"] * max(1.0, float(np.abs(ref).max())))


def test_mdvit_debranches_at_a_ragged_height(tmp_path):
    """MDViT+Sup with each debranch (MLPFM, MLP, DeepLabV3, Transformer),
    B = 4 (one image a domain), ``aux_mode="select"``, the rows over 2 ranks
    in one spawn: the logits, the selected aux logits and feat against
    JAX's unsharded forward within ``FWD_TOL`` of max(1, max|ref|)."""
    rs = np.random.RandomState(21)
    x = rs.standard_normal((4, IMG, IMG, 3)).astype(np.float32)
    dom = np.eye(4, dtype=np.float32)[[2, 0, 3, 1]]
    cases, wants = {}, {}
    for i, name in enumerate(DECODERS):
        model = JaxMDViT(img_size=IMG, adapt="Sup", num_domains=4, decoder_name=name, **TINY)
        variables = random_variables(model, jnp.zeros((4, IMG, IMG, 3)), jnp.asarray(dom),
                                     seed=i)
        wants[name] = jax.jit(lambda v: model.apply(v, x, dom, train=False, out_feat=True,
                                                    aux_mode="select"))(variables)
        cases[name] = {"model": dict(name="MDViT", img_size=IMG, adapt_method="Sup",
                                     decoder_name=name, **TINY),
                       "state_dict": from_jax_variables(variables), "x": torch.from_numpy(x),
                       "dom": torch.from_numpy(dom), "kwargs": {"aux_mode": "select"}}
    spec = tmp_path / "spec.pt"
    torch.save({"cases": cases}, spec)
    res = torch_dp.spawn(torch_cp.zoo_worker, 2, tmp_path, str(spec), str(tmp_path / "out"))
    for r in res:
        for name in DECODERS:
            logits, aux = split_seg(r[name]["seg"])
            want = wants[name]
            assert logits.shape == aux.shape == (4, IMG, IMG, 1)
            for got, ref in ((logits, want["seg"][0]), (aux, want["seg"][1]),
                             (r[name]["feat"], want["feat"])):
                _close_to(got, ref)


@pytest.mark.parametrize("grid", [(2, 2)], ids=["data2_ctx2"])
def test_base_grid_at_a_ragged_height(tmp_path, grid):
    """BASE+Sup on a (data 2, ctx 2) grid of 4 ranks at 100², B = 4 (JAX's
    guards: 2 samples a data rank, 100 // 32 // 2 = 1 row a ctx rank): the
    eval forward's ``seg`` and ``feat`` against JAX's unsharded forward
    within ``FWD_TOL`` of max(1, max|ref|), one CP train step (no dropout)
    against ``jax.value_and_grad`` of JAX's unsharded loss (loss, BN stats,
    the grid's gradients)."""
    model = JaxBASE(img_size=IMG, adapt="Sup", num_domains=4, **TINY)
    variables = _variables(model, 4)
    rs = np.random.RandomState(23)
    x = rs.standard_normal((4, IMG, IMG, 3)).astype(np.float32)
    y = (rs.rand(4, IMG, IMG, 1) > 0.5).astype(np.float32)
    dom = np.eye(4, dtype=np.float32)[[1, 3, 0, 2]]
    want = jax.jit(lambda v: model.apply(v, x, dom, train=False))(variables)
    jax_step = _jax_step(model, variables, x, y, dom)
    spec = {"model": dict(name="BASE", img_size=IMG, adapt_method="Sup", drop_rate=0.0,
                          drop_path_rate=0.0, **TINY),
            "state_dict": from_jax_variables(variables), "x": torch.from_numpy(x),
            "y": torch.from_numpy(y), "dom": torch.from_numpy(dom), "grid": grid,
            "train": True}
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    res = torch_dp.spawn(torch_cp.e2e_worker, 4, tmp_path, str(path), str(tmp_path / "out"))
    for r in res:
        _close_to(r["seg"], want["seg"])
        _close_to(r["feat"], want["feat"])
        _close(float(r["loss"]), float(jax_step["loss"]), rtol=LOSS_RTOL)
        assert r["stats"] and set(r["stats"]) <= set(jax_step["stats"])
        for name, a in r["stats"].items():
            _close(a.numpy(), jax_step["stats"][name].numpy(), err_msg=name, **BN_TOL)
        _grads_close(r["grads"], jax_step["grads"])
