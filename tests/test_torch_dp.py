"""The port's data-parallel train step (``mdvit_tpu_torch/parallel/mesh.py``,
``train/steps.py`` with ``group``) on the CPU, in gloo ranks that
``tests/torch_dp.py`` spawns: against JAX's step sharded over a 4-device
mesh (``tests/test_sharding.py``'s tiny MDViT, its tolerances), against the
port's single-process step with dropout and augmentation on, and the pieces
(the mesh size rule, ``all_reduce_sum``'s gradient, a shard's rows of the
augmentation and the masks)."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mdvit_tpu.models.decoders as jax_decoders
import torch_dp
from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu.ops.layers import Dropout2d as JaxDropout2d
from mdvit_tpu.parallel.mesh import batch_sharding, make_mesh
from mdvit_tpu.train.steps import TrainState
from mdvit_tpu.train.steps import make_train_step as jax_make_train_step
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.data.augment import augment_batch
from mdvit_tpu_torch.data.loader import gather_batch
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.ops.layers import drop_path, dropout2d, fast_dropout
from mdvit_tpu_torch.parallel.mesh import Shard, mesh_size, sharded

torch.set_num_threads(1)

# tests/test_sharding.py's TINY model, batch and tolerances: D = 4 domains of
# B = 4 from stores of 8 images at 16²
TINY = dict(num_layers=(1, 1, 1, 1), embed_dims=(8, 8, 8, 8), mlp_ratios=(1, 1, 1, 1),
            num_heads=(8, 8, 8, 8))
IMG, D, B, N = 16, 4, 4, 8
LOSS_RTOL = 1e-5
BN_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# TransFuse's update against the single process's, relative L2: its ReLUs and
# max-pools route gradients by signs and orders that fp32 sums in another
# order flip (tests/test_torch_zoo_transfuse.py measures the fp32 step's gap
# to its fp64 step, 5.0e-3); four times that
UPDATE_L2_TOL = 2e-2


def _data(img: int = IMG):
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (N, img, img, 3), np.uint8) for _ in range(D)]
    masks = [(rng.rand(N, img, img) > 0.5).astype(np.uint8) for _ in range(D)]
    return images, masks, np.tile(np.arange(B, dtype=np.int32), (D, 1))


def _torch_data(images, masks, idx):
    return ([torch.from_numpy(a) for a in images], [torch.from_numpy(a) for a in masks],
            torch.from_numpy(idx).long())


def _spec(state_dict, drop: float, augment: bool, per_domain: int = B, **model) -> dict:
    images, masks, _ = _data()
    idx = np.tile(np.arange(per_domain, dtype=np.int32), (D, 1))
    return {"model": dict(name="MDViT", img_size=IMG, num_domains=D, adapt_method="Sup",
                          drop_rate=drop, drop_path_rate=drop, **TINY, **model),
            "state_dict": state_dict, "debranch_drop": drop, "lr": 1e-2,
            "num_domains": D, "data": _torch_data(images, masks, idx),
            "step": {"det_sup": True, "mkd": True, "device_augment": augment}}


def _transfuse_spec(state_dict, img: int = 32) -> dict:
    """TransFuse_S at img 32 (its full widths; the smallest size whose ResNet
    layer3 is 2×2), its Dropout2d at 0.2 and the augmentation on, the
    deep-supervision objective."""
    images, masks, idx = _data(img)
    return {"model": dict(name="TransFuse_S", img_size=img, num_domains=D),
            "state_dict": state_dict, "debranch_drop": 0.0, "lr": 1e-2,
            "num_domains": D, "data": _torch_data(images, masks, idx),
            "step": {"mkd": False, "device_augment": True}}


def _ranks(tmp_path, spec, world):
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    return torch_dp.spawn(torch_dp.step_worker, world, tmp_path, str(path),
                          str(tmp_path / "out"))


def _assert_replicas_equal(results):
    for r in results[1:]:
        for k, v in results[0]["state"].items():
            assert torch.equal(r["state"][k], v), k


def _buffer_names(state):
    return [k for k in state if k.endswith(("running_mean", "running_var"))]


def _check(got, metrics, state, buffers, start=None):
    """``got`` (a rank's result) against the reference ``metrics`` and
    ``state`` (parameters and BN stats, port names), JAX's tolerances. With
    ``start`` (the parameters before the step) the update is held as a
    whole, by its relative L2 norm (tests/test_torch_zoo_transfuse.py)."""
    for k in [k for k in ("loss", "aux_loss") if k in metrics]:  # TransFuse: no aux
        np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(np.asarray(got["metrics"]["iou_per_domain"]),
                               np.asarray(metrics["iou_per_domain"]), rtol=1e-5)
    num = den = 0.0
    for k, v in state.items():
        if start is not None and k not in buffers:
            want_update = v.double() - start[k].double()
            num += float(((got["state"][k].double() - start[k].double() - want_update) ** 2).sum())
            den += float((want_update ** 2).sum())
            continue
        tol = BN_TOL if k in buffers else PARAM_TOL
        np.testing.assert_allclose(got["state"][k].numpy(), np.asarray(v), err_msg=k, **tol)
    if start is not None:
        assert (num / den) ** 0.5 <= UPDATE_L2_TOL


@pytest.fixture(scope="module")
def jax_sharded_step():
    """test_sharding.py's setup (init at PRNGKey(0), SGD 1e-2, det_sup, MKD,
    no augmentation), the debranches' Dropout2d at 0 (its threefry masks
    cannot be matched), one step over a 4-device mesh."""
    model = JaxMDViT(adapt="Sup", num_domains=D, img_size=IMG, **TINY)
    x = jnp.zeros((D * B, IMG, IMG, 3))
    oh = jnp.repeat(jnp.eye(D, dtype=jnp.float32), B, 0)
    variables = jax.jit(lambda k: model.init({"params": k, "dropout": k}, x, oh,
                                             train=False, aux_mode="grouped")
                        )(jax.random.PRNGKey(0))
    tx = optax.sgd(1e-2)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(1))
    images, masks, idx = _data()
    mesh = make_mesh(4)
    no_dropout = lambda rate, name: JaxDropout2d(0.0, name=name)  # noqa: E731
    with mock.patch.object(jax_decoders, "Dropout2d", no_dropout), mesh:
        step = jax_make_train_step(model, tx, D, det_sup=True, mkd=True,
                                   device_augment=False, donate=False,
                                   data_sharding=batch_sharding(mesh))
        new, metrics = step(state, tuple(map(jnp.asarray, images)),
                            tuple(map(jnp.asarray, masks)), jnp.asarray(idx))
    after = from_jax_variables({"params": new.params, "batch_stats": new.batch_stats})
    return (from_jax_variables(dict(variables)),
            {k: np.asarray(v) for k, v in metrics.items()}, after)


def test_dp_step_matches_jax_sharded_step(tmp_path, jax_sharded_step):
    """Four gloo ranks of 4 rows each, one domain a rank (the other three
    debranches run on no rows), against JAX's step over a 4-device mesh."""
    start, metrics, after = jax_sharded_step
    results = _ranks(tmp_path, _spec(start, 0.0, False), 4)
    _assert_replicas_equal(results)
    _check(results[0], metrics, after, set(_buffer_names(after)))


@pytest.mark.parametrize("world,name", [(2, "MDViT"), (4, "MDViT"), (2, "TransFuse_S")],
                         ids=["2", "4", "TransFuse_S-2"])
def test_dp_step_matches_single_process(tmp_path, world, name):
    """Dropout, stochastic depth and the debranches' Dropout2d at 0.1 and
    the augmentation on: W ranks draw the single-process step's masks and
    augmentation at their rows, so they take its step. TransFuse_S: its
    deep-supervision branch sums its per-domain terms and eval counts over
    the ranks as the others do."""
    start = None
    if name == "TransFuse_S":
        seeded = build_model(name, img_size=32, num_domains=D, device="cpu", seed=3)
        spec = _transfuse_spec(seeded.state_dict())
        start = {k: v.clone() for k, v in seeded.state_dict().items()}
    else:
        seeded = build_model("MDViT", img_size=IMG, num_domains=D, device="cpu", seed=3,
                             **TINY)
        spec = _spec(seeded.state_dict(), 0.1, True)
    want = torch_dp.run_step(spec)
    results = _ranks(tmp_path, spec, world)
    _assert_replicas_equal(results)
    _check(results[0], want["metrics"], want["state"], set(_buffer_names(want["state"])),
           start)
    assert torch.equal(results[0]["generator"], want["generator"])


def test_dp_step_splits_domains_across_ranks(tmp_path):
    """MDViTᵀ (the Transformer debranch: attention blocks with dropout and
    stochastic depth) with 6 rows a domain in 3 ranks of 8 rows: ranks 0 and
    1 and ranks 1 and 2 share a domain's group, whose debranch draws its
    masks at each row's place in the group; each rank runs the debranches
    of the domains it holds no row of on no rows."""
    seeded = build_model("MDViT", img_size=IMG, num_domains=D, device="cpu", seed=4,
                         decoder_name="Transformer", **TINY)
    spec = _spec(seeded.state_dict(), 0.1, True, per_domain=6, decoder_name="Transformer")
    want = torch_dp.run_step(spec)
    results = _ranks(tmp_path, spec, 3)
    _assert_replicas_equal(results)
    _check(results[0], want["metrics"], want["state"], set(_buffer_names(want["state"])))


def test_all_reduce_sum_gradient(tmp_path):
    """Forward: Σ_r x_r on every rank. Backward: each rank's gradient is the
    sum of the ranks' upstream gradients, Σ_r c_r."""
    results = torch_dp.spawn(torch_dp.all_reduce_worker, 2, tmp_path, str(tmp_path / "out"))
    for res in results:
        np.testing.assert_array_equal(res["sum"].numpy(), [3.0, 6.0, 9.0])
        np.testing.assert_array_equal(res["grad"].numpy(), [3.0, 20.0, 200.0])


@pytest.mark.parametrize("world,cap,total,want", [
    (8, -1, 16, 8), (8, -1, 12, 6), (8, 1, 16, 1), (8, 0, 16, 8), (4, 8, 16, 4),
    (1, -1, 16, 1), (8, 3, 16, 2)])
def test_mesh_size(world, cap, total, want):
    """``tests/test_trainer_dp.py``'s rule: the largest divisor of D·B within
    the world and the cap (-1 and 0: no cap)."""
    assert mesh_size(world, cap, total) == want


def test_shard_draws_its_rows_of_the_batch():
    """Without a group, a shard of rows [4, 12) of 16 gathers, augments and
    drops exactly those rows of the whole batch's."""
    images, masks, idx = _torch_data(*_data())
    whole = gather_batch(images, masks, idx)
    part = gather_batch(images, masks, idx, (4, 8))
    for w, p in zip(whole, part):
        assert torch.equal(w[4:12], p)
    x = torch.randn(16, 6, 6, 5)
    gen_whole, gen_part = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    with torch.no_grad():
        aug_whole = augment_batch(torch.Generator().manual_seed(1), whole[0], whole[1])
        masked_whole = [f(x, 0.3, True, gen_whole) for f in (drop_path, dropout2d, fast_dropout)]
        with sharded(Shard(None, 4, 16)):
            aug_part = augment_batch(torch.Generator().manual_seed(1), part[0], part[1])
            masked_part = [f(x[4:12], 0.3, True, gen_part)
                           for f in (drop_path, dropout2d, fast_dropout)]
    for w, p in zip(aug_whole, aug_part):
        assert torch.equal(w[4:12], p)
    for w, p in zip(masked_whole, masked_part):
        assert torch.equal(w[4:12], p)
