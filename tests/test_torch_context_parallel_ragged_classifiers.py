"""The port's context parallelism of the MPViT, CoaT-Lite and CoaT
classifiers at 100², no multiple of the stride to the deepest grid, on the
CPU, in gloo ranks (``tests/torch_cp.py``) against JAX's unsharded models
with the same seeded flax variables, at ``tests/test_torch_classifiers.py``'s
small widths over 2 ranks. MPViT's SAME-padded chain splits its grids 100,
50, 25, 13, 7, 4 as 64 : 36, 32 : 18, 16 : 9, 8 : 5, 4 : 3, 2 : 2; CoaT's
non-overlapping windows split 100, 25, 12, 6, 3 as 64 : 36, 16 : 9, 8 : 4,
4 : 2, 2 : 1, the last rank's last input rows and last row of the 25-row
grid dropped by the windows as the unsharded model drops them; CoaT's cls
rows on rank 0. The logits and feat within 1e-4·max(1, max|ref|), and the
gradients of the mean cross-entropy of the eval forward, summed over the
ranks and divided by their count, against ``jax.grad`` by
``check_gradients``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp
import torch_dp
from mdvit_tpu_torch.convert import from_jax_variables
from test_torch_classifiers import CASES, CLASSES
from torch_family import check_gradients, random_variables
from torch_zoo import check_maps

torch.set_num_threads(2)

IMG = 100


@pytest.mark.parametrize("cid", CASES)
def test_classifier_at_a_ragged_height(tmp_path, cid):
    jax_cls, port_cls, kw = CASES[cid]
    model = jax_cls(**kw)
    variables = random_variables(model, jnp.zeros((2, IMG, IMG, 3)), None,
                                 call_kw={"train": False})
    rs = np.random.RandomState(8)
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
