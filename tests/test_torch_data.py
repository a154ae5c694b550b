"""The port's data path and config (``mdvit_tpu_torch/data``,
``config.py``, ``utils/pieces.py``) against the JAX package's copies, on
the CPU: the same bytes, index rows, batches, split files and configs."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu import config as jconfig
from mdvit_tpu.data import datasets as jd
from mdvit_tpu.data import loader as jl
from mdvit_tpu.utils import pieces as jp
from mdvit_tpu_torch import config as tconfig
from mdvit_tpu_torch.data import datasets as td
from mdvit_tpu_torch.data import loader as tl
from mdvit_tpu_torch.data import native_loader
from mdvit_tpu_torch.utils import pieces as tp

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["isic2018", "SKD", "other"])
def test_synthetic_domain_arrays_same_bytes(name):
    want = jd.synthetic_domain_arrays(name, 24, 5, 3)
    got = td.synthetic_domain_arrays(name, 24, 5, 3)
    for split in ("train", "test"):
        np.testing.assert_array_equal(got[split].images, want[split].images)
        np.testing.assert_array_equal(got[split].masks, want[split].masks)
        assert got[split].ids == want[split].ids
        assert got[split].domain_id == want[split].domain_id


def test_round_robin_sampler_same_rows_over_three_epochs():
    sizes, bs = [7, 5, 9, 4], 2
    want = jl.RoundRobinSampler(sizes, bs, seed=42)
    got = tl.RoundRobinSampler(sizes, bs, seed=42)
    assert got.steps_per_epoch == want.steps_per_epoch == 4
    for _ in range(3 * got.steps_per_epoch):
        np.testing.assert_array_equal(got.next_batch(), want.next_batch())
    with pytest.raises(ValueError):
        tl.RoundRobinSampler([3, 1], 2)


@pytest.mark.parametrize("batch_size,n_batches", [(5, 2), (7, 1), (3, 3)])
def test_eval_batches_and_index_batches(batch_size, n_batches):
    """Both eval batchings equal JAX's, unpadded and with ``pad_to`` (a
    data-parallel eval's multiple of its ranks, and a value below the batch
    size, which pads nothing)."""
    dom = td.synthetic_domain_arrays("PH2", 16, 0, 7)["test"]
    jdom = jd.DomainArrays(dom.name, dom.domain_id, dom.images, dom.masks)
    for pad_to in (None, batch_size + 1, 4 * batch_size, batch_size - 1):
        for (gi, gm, gv), (wi, wm, wv) in zip(tl.eval_batches(dom, batch_size, pad_to),
                                              jl.eval_batches(jdom, batch_size, pad_to),
                                              strict=True):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
            assert gv == wv and len(gi) == max(pad_to or batch_size, batch_size)
        got = list(tl.eval_index_batches(11, 7, batch_size, pad_to))
        want = list(jl.eval_index_batches(11, 7, batch_size, pad_to))
        assert len(got) == len(want) == n_batches
        for (gi, gv), (wi, wv) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert gv == wv and gi.dtype == np.int32


def test_stores_and_gather_batch_match_jax():
    data = td.build_domain_data(["isic2018", "PH2", "DMF"], "", 16, synthetic=True,
                                synthetic_sizes={"isic2018": (5, 2), "PH2": (4, 3),
                                                 "DMF": (6, 1)})
    store = tl.DeviceDomainStore([data[n]["train"] for n in data], "cpu")
    assert store.sizes == [5, 4, 6] and store.images[1].dtype == torch.uint8
    idx = np.array([[0, 4], [3, 1], [5, 2]], np.int32)
    got = tl.gather_batch(store.images, store.masks, torch.from_numpy(idx).long())
    want = jl.gather_batch(tuple(jnp.asarray(d["train"].images) for d in data.values()),
                           tuple(jnp.asarray(d["train"].masks) for d in data.values()),
                           jnp.asarray(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ev = tl.EvalSplitStore([data[n]["test"] for n in data], "cpu")
    assert ev.domain(2) == (5, 1) and ev.images.shape == (6, 16, 16, 3)
    np.testing.assert_array_equal(ev.images[2:5].numpy(), data["PH2"]["test"].images)


def _write_meta(folder, name, n):
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"meta_{name}.csv"), "w") as f:
        f.write("ID,diagnosis,diagnosis_id\n")
        for i in range(n):
            f.write(f"{i:04d},{'nevus' if i % 3 else 'melanoma'},{i % 3}\n")


def test_split_writers_same_files(tmp_path):
    for mod, sub in ((jd, "jax"), (td, "port")):
        folder = str(tmp_path / sub)
        _write_meta(folder, "PH2", 23)
        mod.write_kfold_splits(folder, "PH2")
        mod.write_ratio_splits(folder, "PH2")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 13
    for name in names:
        want = (tmp_path / "jax" / name).read_text()
        assert (tmp_path / "port" / name).read_text() == want, name


def test_load_domain_arrays_from_npy_corpus(tmp_path):
    """The on-disk layout through both loaders (the port's through its
    g++-built native reader): same arrays, ids and split rows."""
    rs = np.random.RandomState(0)
    folder = tmp_path / "data" / "DMF"
    _write_meta(str(folder), "DMF", 10)
    (folder / "Image").mkdir()
    (folder / "Label").mkdir()
    for i in range(10):
        np.save(folder / "Image" / f"{i:04d}.npy", rs.randint(0, 256, (40, 30, 3)).astype(np.uint8))
        np.save(folder / "Label" / f"{i:04d}.npy", (rs.rand(40, 30) > 0.5).astype(np.uint8))
    got = td.load_domain_arrays(str(tmp_path / "data"), "DMF", 16, k_fold="2")
    want = jd.load_domain_arrays(str(tmp_path / "data"), "DMF", 16, k_fold="2")
    for split in ("train", "test"):
        np.testing.assert_array_equal(got[split].images, want[split].images)
        np.testing.assert_array_equal(got[split].masks, want[split].masks)
        assert got[split].ids == want[split].ids and len(got[split]) > 0


def test_native_loader_reads_and_rejects(tmp_path):
    rs = np.random.RandomState(1)
    arrs = [rs.randint(0, 256, (5, 4, 3)).astype(np.uint8) for _ in range(3)]
    paths = []
    for i, a in enumerate(arrs):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], a)
    np.testing.assert_array_equal(native_loader.batch_load_u8(paths, (5, 4, 3)),
                                  np.stack(arrs))
    np.save(tmp_path / "bad.npy", arrs[0].astype(np.float32))
    assert native_loader.batch_load_u8(paths + [str(tmp_path / "bad.npy")], (5, 4, 3)) is None


def test_default_config_matches_jax_but_the_device():
    got, want = dict(tconfig.DEFAULT_CONFIG), dict(jconfig.DEFAULT_CONFIG)
    assert got.pop("device") == "cuda"
    want.pop("device")
    for key in ("name", "pretrained_folder"):
        got.pop(key, None)
        want.pop(key, None)
    assert got == want


def test_config_from_args_matches_jax(tmp_path):
    yml = tmp_path / "c.yml"
    yml.write_text("train:\n  optimizer:\n    adamw:\n      lr: '3e-4'\n"
                   "data:\n  img_size: 64\n")
    argv = ["--exp_name", "e", "--config_yml", str(yml), "--model", "MDViT",
            "--batch_size", "3", "--adapt_method", "Sup", "--dataset", "PH2", "SKD",
            "--k_fold", "1", "--num_epochs", "7", "--synthetic", "--debug"]
    got = tconfig.config_from_args(tconfig.build_argparser().parse_args(argv)).to_dict()
    want = jconfig.config_from_args(jconfig.build_argparser().parse_args(argv)).to_dict()
    for cfg in (got, want):
        for key in ("name", "device", "pretrained_folder"):
            cfg.pop(key, None)
    assert got == want
    assert got["train"]["optimizer"]["adamw"]["lr"] == 3e-4


def test_save_config_is_json_and_reloads(tmp_path):
    cfg = tconfig.load_config(overrides={"device": "cpu", "data": {"img_size": 32}})
    path = str(tmp_path / "exp_config.yml")
    tconfig.save_config(cfg, path)
    with open(path) as f:
        assert json.load(f) == cfg.to_dict()
    assert tconfig.load_config(path) == cfg
    # the JAX package's YAML reader takes it (YAML reads 1e-08 as a string,
    # which its load_config turns back into a number); both configs have the
    # same keys, pretrained_folder included
    assert jconfig.load_config(path).to_dict() == cfg.to_dict()


@pytest.mark.parametrize("tpu", [{"mesh": {"data": 2}}, {"distributed": True}])
def test_unported_tpu_settings_raise(tpu, monkeypatch):
    """Both settings are ported now: ``mesh.data`` caps the data-parallel
    group and passes, ``distributed`` raises only outside torchrun's
    environment."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = tconfig.load_config(overrides={"tpu": tpu})
    if "distributed" in tpu:
        with pytest.raises(RuntimeError, match="torchrun"):
            tconfig.check_supported(cfg)
        monkeypatch.setenv("WORLD_SIZE", "2")
    tconfig.check_supported(cfg)
    tconfig.check_supported(tconfig.load_config(overrides={"tpu": {"mesh": {"data": 1}}}))


def test_pieces_match_jax():
    data = {"a": {"b": 1, "c": [1, {"d": 2}]}, "e": 3.5}
    got, want = tp.DotDict(data), jp.DotDict(data)
    assert got.to_dict() == want.to_dict() and got.a.c[1].d == 2
    with pytest.raises(AttributeError):
        got.missing
    assert list(tp.flatten_dict(data)) == list(jp.flatten_dict(data))
    gm, wm = tp.AvgMeter(), jp.AvgMeter()
    for v, n in ((1.0, 2), (4.0, 1)):
        gm.update(v, n)
        wm.update(v, n)
    assert (gm.avg, gm.val, gm.count) == (wm.avg, wm.val, wm.count)


@pytest.mark.parametrize("mode", ["adamw", "adam"])
def test_build_optimizer_from_config_matches_optax(mode):
    """The optimizer and StepLR read from the config as the JAX package's
    ``build_optimizer`` reads them: three updates across a staircase
    boundary (step_size 1 epoch of 2 steps) on fixed gradients."""
    import jax
    import optax

    from mdvit_tpu.train.optim import build_optimizer as jax_build_optimizer
    from mdvit_tpu_torch.train.optim import build_optimizer, steplr

    over = {"train": {"optimizer": {"mode": mode,
                                    "adamw": {"lr": 2e-3, "betas": [0.8, 0.99], "eps": 1e-6,
                                              "weight_decay": 0.1},
                                    "adam": {"lr": 3e-3}},
                      "scheduler": {"step_size": 1, "gamma": 0.25}}}
    rs = np.random.RandomState(3)
    p0 = {"a": rs.standard_normal((4, 3)).astype(np.float32),
          "b": rs.standard_normal(5).astype(np.float32)}
    grads = [{k: rs.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = jax_build_optimizer(jconfig.load_config(overrides=over), 2)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    cfg = tconfig.load_config(overrides=over)
    opt, sched = build_optimizer(module, 2, cfg)
    base = 2e-3 if mode == "adamw" else 3e-3
    for i, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(steplr(cfg, 2, i))
        assert steplr(cfg, 2, i) == pytest.approx(base * 0.25 ** (i // 2))
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                       rtol=0, atol=1e-6)
