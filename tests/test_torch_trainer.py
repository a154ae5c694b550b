"""The port's Trainer and CLI (``mdvit_tpu_torch/train/trainer.py``,
``cli.py``) on the CPU: ``evaluate`` against the JAX Trainer's on the same
weights, a ``--synthetic --debug`` CLI run, and a bit-exact resume."""
import copy
import csv
import os

import numpy as np
import pytest
import torch

from mdvit_tpu.config import load_config as jax_load_config
from mdvit_tpu.train.trainer import Trainer as JaxTrainer
from mdvit_tpu.train.trainer import results_table as jax_results_table
from mdvit_tpu.train.steps import make_eval_step as jax_make_eval_step
from mdvit_tpu_torch import cli
from mdvit_tpu_torch.config import load_config
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

# tests/test_trainer_dp.py's tiny model and synthetic sizes
TINY_MODEL = {"num_layers": [1, 1, 1, 1], "embed_dims": [8, 8, 8, 8],
              "mlp_ratios": [1, 1, 1, 1], "num_heads": [8, 8, 8, 8]}
SIZES = {"isic2018": [6, 7], "PH2": [6, 7], "DMF": [6, 7], "SKD": [6, 7]}
# eval losses and overlap ratios: the forwards sum in another order
EVAL_RTOL = 1e-4


def _overrides(**extra):
    cfg = copy.deepcopy({
        "data": {"img_size": 16, "synthetic": True, "synthetic_sizes": SIZES},
        "train": {"num_epochs": 1, "batch_size": 2},
        "test": {"batch_size": 5}, "model_kwargs": TINY_MODEL,
        "tpu": {"compute_dtype": "float32", "mesh": {"data": 1}}})
    for k, v in extra.items():
        if isinstance(v, dict):
            cfg.setdefault(k, {}).update(v)
        else:
            cfg[k] = v
    return cfg


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    return JaxTrainer(jax_load_config(overrides=_overrides()),
                      str(tmp_path_factory.mktemp("jax")))


@pytest.mark.parametrize("device_eval", [True, False], ids=["store", "host"])
def test_evaluate_matches_jax_trainer(tmp_path, jax_trainer, device_eval):
    """The JAX Trainer's initial weights in both trainers; every key of
    every domain's result within EVAL_RTOL (7 test images in batches of 5:
    a full batch and a padded tail). The JAX Trainer is built once; its
    eval mode is switched as its constructor sets it for
    ``tpu.device_eval``."""
    jtr = jax_trainer
    jtr.device_eval = device_eval
    jtr.eval_step = jax_make_eval_step(jtr.model, mkd=True, from_store=device_eval)
    over = _overrides(tpu={"device_eval": device_eval})
    tr = Trainer(load_config(overrides={**over, "device": "cpu"}), str(tmp_path / "port"))
    tr.model.load_state_dict(from_jax_variables(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}))
    want, got = jtr.evaluate("test"), tr.evaluate("test")
    assert set(got) == set(want) == set(SIZES)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key, value in want[name].items():
            np.testing.assert_allclose(got[name][key], value, rtol=EVAL_RTOL, atol=1e-7,
                                       err_msg=f"{name}/{key}")


def _cli_config(tmp_path, **train):
    path = tmp_path / "tiny.yml"
    path.write_text(
        "device: cpu\n"
        "data: {img_size: 16, synthetic_sizes: {isic2018: [6, 3], PH2: [6, 3], "
        "DMF: [6, 3], SKD: [6, 3]}}\n"
        f"train: {{batch_size: 2, num_epochs: {train.get('num_epochs', 2)}, "
        "save_last_every: 1}\n"
        "test: {batch_size: 2}\n"
        "model_kwargs: {num_layers: [1, 1, 1, 1], embed_dims: [8, 8, 8, 8], "
        "mlp_ratios: [1, 1, 1, 1], num_heads: [8, 8, 8, 8]}\n"
        "tpu: {compute_dtype: float32}\n")
    return str(path)


def test_cli_synthetic_debug_writes_test_results(tmp_path):
    exp = tmp_path / "exp"
    tr = cli.main(["--exp_name", "smoke", "--model", "MDViT", "--synthetic", "--debug",
                   "--config_yml", _cli_config(tmp_path), "--exp_dir", str(exp),
                   "--profile_steps", "1"])
    assert tr.history[0]["steps"] == 1  # debug: one batch per loop, one epoch
    assert (exp / "profile" / "trace.json").stat().st_size > 0
    with open(exp / "test_results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    jax_cols = list(jax_results_table(["a"], {"a": {"loss": 1.0, "dice": 0.5,
                                                    "iou": 0.4}}).columns)
    assert list(rows[0]) == jax_cols
    assert [r["Name"] for r in rows] == ["isic2018", "PH2", "DMF", "SKD", "Total"]
    total = rows[-1]
    assert float(total["loss"]) == pytest.approx(sum(float(r["loss"]) for r in rows[:-1]))
    assert float(total["IOU"]) == pytest.approx(np.mean([float(r["IOU"]) for r in rows[:-1]]))
    for name in ("best.pt", "last.pt", "exp_config.yml", "scalars.jsonl"):
        assert (exp / name).is_file(), name

    # predict --ckpt_dir restores best.pt into the model exp_config.yml describes
    from mdvit_tpu_torch import predict
    from mdvit_tpu_torch.train import checkpoints as ckpt

    img = np.random.RandomState(0).randint(0, 256, (16, 16, 3)).astype(np.uint8)
    np.save(tmp_path / "x.npy", img)
    predict.main(["--ckpt_dir", str(exp), "--config_yml", str(exp / "exp_config.yml"),
                  "--inputs", str(tmp_path / "x.npy"), "--out_dir", str(tmp_path / "p"),
                  "--domain", "2", "--batch_size", "1", "--save_prob", "--device", "cpu"])
    tr.model.load_state_dict(ckpt.load_best(str(exp))["model"])
    want = predict.make_forward(tr.model)(torch.from_numpy(img).float()[None],
                                          torch.eye(4)[[2]])[0]
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "x_prob.npy"), want.numpy())


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


def _state_equal(a: Trainer, b: Trainer) -> None:
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and _same_bits(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert _same_bits(v, sb["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert torch.equal(a.train_step.generator.get_state(), b.train_step.generator.get_state())
    assert torch.equal(a.train_step.aug_generator.get_state(),
                       b.train_step.aug_generator.get_state())
    assert a.step == b.step


def test_resume_restores_identical_state(tmp_path):
    """fit() 2 epochs with ``last`` every epoch; a second Trainer on the same
    dir with 3 epochs resumes from ``last`` with bit-equal parameters,
    optimizer and scheduler state and generator states, trains epoch 2 and
    tests. bf16, the config's default. img 32, not 16: at 16 the last patch
    embed's depthwise conv sees a 1×1 map, where PyTorch's CPU bf16 conv
    backward gives a NaN weight gradient now and then (seen in ~1 of 100
    calls of F.conv2d alone, never at 2×2)."""
    exp = str(tmp_path / "exp")
    over = {"device": "cpu", "data": {"img_size": 32, "synthetic": True,
                                      "synthetic_sizes": {k: [4, 2] for k in SIZES}},
            "train": {"num_epochs": 2, "batch_size": 2, "save_last_every": 1},
            "test": {"batch_size": 2}, "model_kwargs": TINY_MODEL,
            "tpu": {"compute_dtype": "bfloat16"}}
    first = Trainer(load_config(overrides=over), exp)
    first.fit()
    assert all(torch.isfinite(v).all() for v in first.model.state_dict().values()
               if v.is_floating_point())
    assert first.step == 4 and [h["epoch"] for h in first.history] == [0, 1]
    over["train"]["num_epochs"] = 3
    second = Trainer(load_config(overrides=over), exp)
    second.maybe_resume()
    assert second.start_epoch == 2
    assert second.max_iou == first.max_iou and second.best_epoch == first.best_epoch
    _state_equal(first, second)
    second.fit()
    assert second.step == 6 and [h["epoch"] for h in second.history] == [2]
    rows = second.test()
    assert rows[-1]["Name"] == "Total" and os.path.isfile(os.path.join(exp, "test_results.csv"))


@pytest.mark.parametrize("over,match", [
    ({"model": "coat_tiny"}, "'coat_tiny' is a classifier"),
    ({"model": "mpvit_tiny"}, "'mpvit_tiny' is a classifier"),
    ({"model": "coat_lite_tiny"}, "'coat_lite_tiny' is a classifier"),
])
def test_unported_models_raise(tmp_path, over, match):
    """The classifiers build, but the Trainer segments: it refuses them
    before it writes anything."""
    cfg = load_config(overrides={**_overrides(**over), "device": "cpu"})
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, str(tmp_path / "exp"))
    assert not (tmp_path / "exp").exists()


# the model family of the paper's comparisons: (model, adapt_method, decoder_name)
FAMILY = {
    "BASE": ("BASE", False, None), "BASE_Sup": ("BASE", "Sup", None),
    "BASE_DSN": ("BASE_DSN", False, None), "BASE_DASE": ("BASE_DASE", False, None),
    "BASE_USE": ("BASE_USE", False, None), "MDViT_DSN": ("MDViT_DSN", "Sup", None),
    "MDViT_MLP": ("MDViT", "Sup", "MLP"), "MDViT_DeepLabV3": ("MDViT", "Sup", "DeepLabV3"),
    "MDViT_Transformer": ("MDViT", "Sup", "Transformer"), "MDViT_noSup": ("MDViT", False, None),
}


@pytest.mark.parametrize("row", list(FAMILY))
def test_trainer_builds_the_family(tmp_path, row):
    """Trainer builds each model by its registry name on the CPU, with the
    MKD objective exactly for the MDViT names."""
    name, adapt, decoder = FAMILY[row]
    kw = {**TINY_MODEL, "decoder_name": decoder} if decoder else TINY_MODEL
    cfg = load_config(overrides={**_overrides(model=name, model_kwargs=kw,
                                              model_adapt={"adapt_method": adapt}),
                                 "device": "cpu"})
    tr = Trainer(cfg, str(tmp_path / "exp"))
    assert tr.mkd == name.startswith("MDViT")
    assert tr.model.config["name"] == name
    names = [n for n, _ in tr.model.named_parameters()]
    assert any("domain_layer" in n for n in names) == bool(adapt)
    assert any("debranch" in n for n in names) == tr.mkd
    assert any(".bns." in n for n in names) == name.endswith("DSN")


def test_entry_points_take_every_model(tmp_path):
    """The three entry-point faults the model family reaches: a model with no
    ``domain_layer`` parameter trains with det_sup on (one pull, no
    ``autograd.grad`` over nothing); BASE's ``seg`` (a tensor) is not
    unpacked as a ``(logits, aux)`` pair, which at B = 2 would take the two
    samples for the two heads; and a weight file names its model, which
    ``load_weights`` rebuilds."""
    from mdvit_tpu_torch.data.preprocess import normalize
    from mdvit_tpu_torch.models.registry import build_model, load_weights, save_weights
    from mdvit_tpu_torch.predict import make_forward
    from mdvit_tpu_torch.train.optim import build_optimizer
    from mdvit_tpu_torch.train.steps import make_eval_step, make_train_step

    rs = np.random.RandomState(0)
    images = [torch.from_numpy(rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8))
              for _ in range(2)]
    masks = [torch.from_numpy((rs.rand(2, 32, 32) > 0.5).astype(np.uint8)) for _ in range(2)]
    indices = torch.tensor([[0], [1]])
    tiny = {k: tuple(v) for k, v in TINY_MODEL.items()}

    gateless = build_model("MDViT", img_size=32, num_domains=2, adapt_method=None,
                           device="cpu", **tiny)
    opt, sch = build_optimizer(gateless, steps_per_epoch=1)
    m = make_train_step(gateless, opt, sch, 2, det_sup=True, device_augment=False)(
        images, masks, indices)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["aux_loss"])

    base = build_model("BASE_DSN", img_size=32, num_domains=2, device="cpu", **tiny)
    x = torch.stack([images[0][0], images[1][1]]).float()
    y = torch.stack([masks[0][0], masks[1][1]]).float()[..., None]
    oh = torch.eye(2)
    probs = make_forward(base)(x, oh)
    assert probs.shape == (2, 32, 32)
    with torch.no_grad():
        logits = base(normalize(x), oh)["seg"]
    torch.testing.assert_close(probs, torch.sigmoid(logits)[..., 0])
    ev = make_eval_step(base, mkd=False)(x, y[..., 0], oh, 2)
    assert ev["primary"]["sum_pred"].item() == (torch.sigmoid(logits) > 0.5).sum().item()
    opt, sch = build_optimizer(base, steps_per_epoch=1)
    base_copy = copy.deepcopy(base).train()
    m = make_train_step(base, opt, sch, 2, mkd=False, device_augment=False)(
        images, masks, indices)
    assert m["loss_per_domain"].shape == (2,)

    path = str(tmp_path / "w.pt")
    save_weights(path, base_copy.eval())
    back = load_weights(path, device="cpu")
    assert type(back).__name__ == "BASE" and back.config["name"] == "BASE_DSN"
    for k, v in base_copy.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    blob = torch.load(path, weights_only=True)
    blob["model"] = blob["config"]["name"] = "coat_tiny"
    torch.save(blob, path)
    with pytest.raises(ValueError, match="do not build 'coat_tiny'"):
        load_weights(path, device="cpu")


def test_cli_trains_base_dsn(tmp_path):
    """``--model BASE_DSN --synthetic --debug`` on the CPU: the single
    objective's scalars, eval without a debranch, the results table."""
    exp = tmp_path / "exp"
    tr = cli.main(["--exp_name", "dsn", "--model", "BASE_DSN", "--synthetic", "--debug",
                   "--config_yml", _cli_config(tmp_path), "--exp_dir", str(exp)])
    assert not tr.mkd and tr.history[0]["steps"] == 1
    with open(exp / "test_results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["Name"] for r in rows] == ["isic2018", "PH2", "DMF", "SKD", "Total"]
    assert all(np.isfinite(float(r[k])) for r in rows for k in ("loss", "Di_score", "IOU"))


def test_train_aug_needs_device_augment(tmp_path):
    cfg = load_config(overrides={**_overrides(tpu={"device_augment": False}),
                                 "device": "cpu"})
    with pytest.raises(ValueError, match="device_augment"):
        Trainer(cfg, str(tmp_path / "exp"))
