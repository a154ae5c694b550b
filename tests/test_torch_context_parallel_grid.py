"""The port's (data, ctx) grid on the CPU: ``make_dp_context_mesh(2, 2)`` over
4 gloo ranks (``tests/torch_cp.py``) with JAX's tiny BASE
(``test_torch_context_parallel_e2e.py``'s sizes) against the port's
unsharded forward and train step, and the guards."""
import torch_cp
import torch_dp
from mdvit_tpu.models.base import BASE as JaxBASE
from test_torch_context_parallel_e2e import (FWD_TOL, IMG, LOSS_RTOL, TINY, _close, _data,
                                             _grads_close, _spec, _variables)


def test_dp_cp_grid_step_and_guards(tmp_path):
    """On a (data 2, ctx 2) grid of 4 ranks at B 4: the forward and one train
    step against the port's unsharded ones (loss, BN stats at JAX's DP×CP
    tolerance, gradients); then the guards: 4 ctx ranks at 64² (a 2×2
    deepest grid) and the 1×1 tile at B 2 on the grid raise JAX's errors."""
    model = JaxBASE(img_size=IMG, adapt="Sup", num_domains=4, **TINY)
    variables = _variables(model, 4)
    x, y, dom = _data(4, seed=4)
    spec, path = _spec(tmp_path, "BASE", variables, x, y, dom, grid=(2, 2), train=True)
    res = torch_dp.spawn(torch_cp.e2e_worker, 4, tmp_path, path, str(tmp_path / "out"))
    ref = {**torch_cp.forwards(spec, None), **torch_cp.train_step(spec, None)}
    for r in res:
        _close(r["seg"].numpy(), ref["seg"].numpy(), **FWD_TOL)
        _close(float(r["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)
        for n, a in ref["stats"].items():
            _close(r["stats"][n].numpy(), a.numpy(), rtol=1e-3, atol=1e-4, err_msg=n)
        _grads_close(r["grads"], ref["grads"])
    msgs = torch_dp.spawn(torch_cp.guard_worker, 4, tmp_path / "out", path,
                          str(tmp_path / "out" / "out"))
    for m in msgs:
        assert "ctx" in m["min_grid"]
        assert "DP x CP" in m["tile"]
