"""``python -m mdvit_tpu_torch.extract_features`` against
``scripts/extract_features.py``, on the CPU.

A tiny MDViT (tests/test_extract_features.py's widths) with the same seeded
variables on both sides: the JAX script's restore returns them, the port
reads them from a ``save_weights`` file. On the synthetic corpus and on an
on-disk npy corpus with a ``meta_<name>.csv``: features within 1e-4 of
their scale, ids, domain ids and diagnosis ids equal.
"""
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

import scripts.extract_features as jax_script
from mdvit_tpu.models.registry import get_model
from mdvit_tpu_torch import extract_features
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.registry import build_model, save_weights
from torch_family import TINY, random_variables

torch.set_num_threads(2)

IMG = 32
KWARGS = ('{"num_layers": [1, 1, 1, 1], "embed_dims": [8, 8, 8, 8], '
          '"mlp_ratios": [1, 1, 1, 1], "num_heads": [8, 8, 8, 8]}')


def _weights(tmp_path, num_domains):
    """Seeded flax variables of the script's model and the port's weight
    file holding them."""
    model = get_model("MDViT", img_size=IMG, num_domains=num_domains, adapt_method="Sup",
                      **TINY)
    oh = jnp.repeat(jnp.eye(num_domains, dtype=jnp.float32), 2, 0)
    variables = random_variables(model, jnp.zeros((2 * num_domains, IMG, IMG, 3)), oh)
    port = build_model("MDViT", img_size=IMG, num_domains=num_domains, device="cpu", **TINY)
    port.load_state_dict(from_jax_variables(variables, port))
    path = str(tmp_path / "weights.pt")
    save_weights(path, port)
    return variables, path


def _run_both(tmp_path, datasets, data_args):
    variables, weights = _weights(tmp_path, len(datasets))
    common = ["--img_size", str(IMG), "--batch_size", "4", "--dataset", *datasets, *data_args]
    argv = ["extract_features.py", "--ckpt", "restored", "--model_kwargs", KWARGS,
            "--out", str(tmp_path / "jax"), *common]
    with mock.patch.object(sys, "argv", argv), \
            mock.patch.object(jax_script.ckpt, "restore_pytree", lambda path, like: variables):
        jax_script.main()
    extract_features.main(["--ckpt", weights, "--device", "cpu", "--out",
                           str(tmp_path / "port"), *common])
    for name in datasets:
        want = np.load(tmp_path / "jax" / f"features_{name}.npz", allow_pickle=True)
        got = np.load(tmp_path / "port" / f"features_{name}.npz", allow_pickle=True)
        assert got["features"].shape == want["features"].shape
        np.testing.assert_allclose(got["features"], want["features"], rtol=0,
                                   atol=1e-4 * np.abs(want["features"]).max())
        for key in ("diagnosis_id", "domain_id", "ids"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        yield name, got


def test_synthetic_corpus_matches_jax(tmp_path):
    out = dict(_run_both(tmp_path, ["isic2018", "PH2"], ["--synthetic"]))
    assert out["isic2018"]["features"].shape == (24, 8)  # the synthetic train size
    assert set(out["PH2"]["domain_id"]) == {1}
    assert not np.allclose(out["isic2018"]["features"].mean(0), out["PH2"]["features"].mean(0))


def test_meta_csv_diagnosis_matches_jax(tmp_path):
    """An npy corpus of 6 samples: the k-fold train split's features and its
    diagnosis ids from ``meta_PH2.csv``, matched by ID."""
    root = tmp_path / "data" / "PH2"
    (root / "Image").mkdir(parents=True)
    (root / "Label").mkdir()
    rs = np.random.RandomState(0)
    lines = ["ID,diagnosis,diagnosis_id"]
    for i in range(6):
        sid = f"IMD{i:03d}"
        np.save(root / "Image" / f"{sid}.npy", rs.randint(0, 255, (40, 40, 3), np.uint8))
        np.save(root / "Label" / f"{sid}.npy", (rs.rand(40, 40) > 0.5).astype(np.uint8))
        lines.append(f"{sid},d,{i % 3}")
    (root / "meta_PH2.csv").write_text("\n".join(lines) + "\n")
    (name, got), = _run_both(tmp_path, ["PH2"], ["--data_folder", str(tmp_path / "data")])
    ids = [str(s) for s in got["ids"]]
    assert 0 < len(ids) <= 6
    np.testing.assert_array_equal(got["diagnosis_id"], [int(s[3:]) % 3 for s in ids])


def test_random_weights_and_experiment_checkpoints(tmp_path):
    """Without ``--ckpt`` the weights come from ``--seed``; a checkpoint
    file of an experiment dir is rebuilt from its config."""
    from mdvit_tpu_torch.config import load_config, save_config
    from mdvit_tpu_torch.train.checkpoints import CheckpointWriter

    kw = dict(TINY)
    a = extract_features.load_model(None, "MDViT", IMG, 2, torch.device("cpu"), 3, **kw)
    b = build_model("MDViT", img_size=IMG, num_domains=2, device="cpu", seed=3, **kw)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    exp = tmp_path / "exp"
    exp.mkdir()
    cfg = load_config(overrides={
        "device": "cpu", "data": {"img_size": IMG, "name": ["isic2018", "PH2"]},
        "model_adapt": {"num_domains": 2}, "model_kwargs": {k: list(v) for k, v in kw.items()}})
    save_config(cfg, str(exp / "exp_config.yml"))
    writer = CheckpointWriter(str(exp))
    writer.save_best(b)
    writer.close()
    for ckpt in (str(exp), str(exp / "best.pt")):
        m = extract_features.load_model(ckpt, "ignored", IMG, 2, torch.device("cpu"))
        assert all(torch.equal(v, m.state_dict()[k]) for k, v in b.state_dict().items())
