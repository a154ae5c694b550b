"""The port's context parallelism of the MPViT, CoaT-Lite and CoaT classifiers
and of MDViT's DeepLabV3 debranch on the CPU, in gloo ranks
(``tests/torch_cp.py``), against JAX's unsharded models with the same seeded
flax variables.

The classifiers at ``tests/test_torch_classifiers.py``'s small widths, img
96 over 2 ranks (deepest grid 3 rows: 2 + 1; CoaT's cls rows on rank 0):
the logits and feat within 1e-4·max(1, max|ref|), and the gradients of the
mean cross-entropy of the eval forward, summed over the ranks and divided
by their count (each rank's pull is the ranks' count times its share),
against ``jax.grad`` by ``check_gradients``. MDViT with the DeepLabV3
debranch (``test_torch_context_parallel_e2e.py``'s tiny widths, img 96 over
2 ranks: the dilated branches' halos reach past both ranks): the forward's
logits, aux logits and feat within ``FWD_TOL`` of max(1, max|ref|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp
import torch_dp
from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.base import split_seg
from test_torch_classifiers import CASES, CLASSES
from test_torch_context_parallel_e2e import FWD_TOL, TINY, _variables
from torch_family import check_gradients, random_variables
from torch_zoo import check_maps

torch.set_num_threads(2)

IMG = 96


@pytest.mark.parametrize("cid", CASES)
def test_classifier_on_two_ranks_matches_jax(tmp_path, cid):
    jax_cls, port_cls, kw = CASES[cid]
    model = jax_cls(**kw)
    variables = random_variables(model, jnp.zeros((2, IMG, IMG, 3)), None,
                                 call_kw={"train": False})
    rs = np.random.RandomState(4)
    x = rs.standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    labels = rs.randint(0, CLASSES, 3)

    def loss(params):
        logits = model.apply({**variables, "params": params}, x, train=False)["logits"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1))

    want = jax.jit(lambda v: model.apply(v, x, train=False))(variables)
    grads = jax.jit(jax.grad(loss))(variables["params"])
    port = port_cls(**kw)
    spec = tmp_path / "spec.pt"
    torch.save({"cls": "mpvit" if cid == "mpvit" else "coat", "kw": kw,
                "state_dict": from_jax_variables(variables, port), "x": torch.from_numpy(x),
                "labels": torch.from_numpy(labels).long()}, spec)
    res = torch_dp.spawn(torch_cp.classifier_worker, 2, tmp_path, str(spec), str(tmp_path / "out"))
    want_grads = {"grads": from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})}
    for r in res:
        assert r["logits"].shape == (3, CLASSES)
        check_maps([np.asarray(want["logits"]), np.asarray(want["feat"])],
                   [r["logits"].numpy(), r["feat"].numpy()])
        check_gradients(want_grads, r["grads"])


def test_mdvit_deeplabv3_on_two_ranks_matches_jax(tmp_path):
    model = JaxMDViT(img_size=IMG, adapt="Sup", num_domains=4, decoder_name="DeepLabV3",
                     **TINY)
    variables = _variables(model, 4, aux_mode="grouped")
    rs = np.random.RandomState(5)
    x = rs.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    dom = np.eye(4, dtype=np.float32)[[1, 3]]
    want = jax.jit(lambda v: model.apply(v, x, dom, train=False, out_feat=True,
                                         aux_mode="select"))(variables)
    spec = {"model": dict(name="MDViT", img_size=IMG, adapt_method="Sup",
                          decoder_name="DeepLabV3", **TINY),
            "state_dict": from_jax_variables(variables), "x": torch.from_numpy(x),
            "dom": torch.from_numpy(dom), "kwargs": {"aux_mode": "select"}}
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    res = torch_dp.spawn(torch_cp.e2e_worker, 2, tmp_path, str(path), str(tmp_path / "out"))
    for r in res:
        logits, aux = split_seg(r["seg"])
        for got, ref in ((logits, want["seg"][0]), (aux, want["seg"][1]),
                         (r["feat"], want["feat"])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=FWD_TOL["atol"] * max(1.0, float(np.abs(ref).max())))
