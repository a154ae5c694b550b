"""MDViT's end-to-end context parallelism on the CPU: JAX's tiny MDViT
(``test_torch_context_parallel_e2e.py``'s sizes, MLPFM debranches) with the
image rows over 2 gloo ranks (``tests/torch_cp.py``) against JAX's
unsharded forward."""
import jax

import torch_cp
import torch_dp
from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu_torch.models.base import split_seg
from test_torch_context_parallel_e2e import FWD_TOL, IMG, TINY, _close, _data, _spec, _variables


def test_mdvit_forward_on_two_ranks(tmp_path):
    """MDViT (MLPFM debranches, ``aux_mode="select"``) with the rows over 2
    ranks against JAX unsharded: the logits and the selected aux logits."""
    model = JaxMDViT(img_size=IMG, adapt="Sup", num_domains=4, **TINY)
    variables = _variables(model, 4, aux_mode="grouped")
    x, y, dom = _data(2, seed=3)
    want = jax.jit(lambda v: model.apply(v, x, dom, train=False, out_feat=True,
                                         aux_mode="select"))(variables)
    _, path = _spec(tmp_path, "MDViT", variables, x, y, dom, kwargs={"aux_mode": "select"})
    res = torch_dp.spawn(torch_cp.e2e_worker, 2, tmp_path, path, str(tmp_path / "out"))
    for r in res:
        logits, aux = split_seg(r["seg"])
        _close(logits.numpy(), want["seg"][0], **FWD_TOL)
        _close(aux.numpy(), want["seg"][1], **FWD_TOL)
        _close(r["feat"].numpy(), want["feat"], **FWD_TOL)
