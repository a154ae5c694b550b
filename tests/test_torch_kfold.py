"""The port's k-fold tools on the CPU: two tiny synthetic folds through the
port's CLI (``python -m mdvit_tpu_torch.cli``, subprocesses, debug mode, the
widths of tests/test_kfold_e2e.py), then ``mdvit_tpu_torch.kfold_aggregate``
against ``scripts/kfold_aggregate.py`` (pandas, which the card's machine
lacks) and ``mdvit_tpu_torch.summarize_run`` against
``scripts/summarize_run.py`` on the same files."""
import contextlib
import io
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pandas as pd
import pytest

import scripts.summarize_run as jax_summarize_run
from mdvit_tpu_torch import kfold_aggregate, summarize_run
from scripts.kfold_aggregate import aggregate as jax_aggregate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# pandas' default csv parser can round a decimal's last bit (the port reads
# with Python's float, which rounds correctly): 1e-12 of the value
RTOL = 1e-12
# tests/test_kfold_e2e.py's TINY_YML, on the CPU
TINY = {
    "device": "cpu",
    "debug": True,
    "data": {"img_size": 16, "synthetic": True, "name": ["isic2018", "PH2"],
             "synthetic_sizes": {"isic2018": [6, 4], "PH2": [6, 4]}},
    "train": {"num_epochs": 1, "batch_size": 2},
    "test": {"batch_size": 4},
    "model_kwargs": {"num_layers": [1, 1, 1, 1], "embed_dims": [8, 8, 8, 8],
                     "mlp_ratios": [1, 1, 1, 1], "num_heads": [8, 8, 8, 8]},
    "tpu": {"compute_dtype": "float32"},
}


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """Two folds trained and tested by the port's CLI."""
    root = tmp_path_factory.mktemp("kfold")
    cfg = root / "tiny.yml"
    cfg.write_text(json.dumps(TINY))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    exp_dirs = []
    for fold in ("0", "1"):
        exp_dir = str(root / f"fold{fold}")
        proc = subprocess.run(
            [sys.executable, "-m", "mdvit_tpu_torch.cli", "--exp_name", f"kf{fold}",
             "--model", "MDViT", "--config_yml", str(cfg), "--k_fold", fold,
             "--exp_dir", exp_dir],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert os.path.exists(os.path.join(exp_dir, "test_results.csv")), proc.stdout[-2000:]
        exp_dirs.append(exp_dir)
    return exp_dirs


def test_aggregate_matches_jax_script(folds, tmp_path):
    got = kfold_aggregate.aggregate(folds)
    want = jax_aggregate(folds)
    # notebook cell 5 schema
    assert list(got) == list(want.columns) == [
        "Name", "loss_m", "loss_s", "Di_score_m", "Di_score_s", "IOU_m", "IOU_s"]
    assert got["Name"] == list(want["Name"]) == ["isic2018", "PH2", "Total"]
    for col in list(want.columns)[1:]:
        np.testing.assert_allclose(got[col], want[col].values.astype(float), rtol=RTOL,
                                   atol=1e-15, err_msg=col)
    assert np.isfinite(got["Di_score_m"]).all()
    # the CLI's file reads back as the script's frame
    out = tmp_path / "k_fold.csv"
    kfold_aggregate.main(["--exp_dirs", *folds, "--out", str(out)])
    written = pd.read_csv(out)
    assert list(written.columns) == list(want.columns)
    assert list(written["Name"]) == list(want["Name"])
    for col in list(want.columns)[1:]:
        np.testing.assert_allclose(written[col].values, want[col].values, rtol=RTOL,
                                   atol=1e-15, err_msg=col)


def test_aggregate_takes_population_std(folds):
    got = kfold_aggregate.aggregate(folds)
    f0, f1 = (pd.read_csv(os.path.join(d, "test_results.csv")) for d in folds)
    for col in ("loss", "Di_score", "IOU"):
        np.testing.assert_allclose(got[f"{col}_m"], (f0[col].values + f1[col].values) / 2,
                                   rtol=RTOL)
        np.testing.assert_allclose(got[f"{col}_s"],
                                   np.std(np.stack([f0[col].values, f1[col].values]), axis=0),
                                   rtol=RTOL, atol=1e-15)


def _write(path, names, values):
    path.mkdir()
    pd.DataFrame({"Name": names, "dice": values}).to_csv(path / "test_results.csv",
                                                          index=False)


def test_aggregate_aligns_rows_and_refuses_a_mismatch(tmp_path):
    """Rows keyed by Name, not by position; a fold with other rows raises."""
    a, b, c = tmp_path / "f0", tmp_path / "f1", tmp_path / "f2"
    _write(a, ["isic2018", "PH2", "Total"], [0.8, 0.6, 0.7])
    _write(b, ["PH2", "isic2018", "Total"], [0.4, 1.0, 0.7])
    _write(c, ["DMF", "Total"], [0.5, 0.5])
    got = kfold_aggregate.aggregate([str(a), str(b)])
    want = jax_aggregate([str(a), str(b)])
    assert got["Name"] == ["isic2018", "PH2", "Total"]
    np.testing.assert_allclose(got["dice_m"], [0.9, 0.5, 0.7])
    np.testing.assert_allclose(got["dice_m"], want["dice_m"].values.astype(float), rtol=RTOL)
    for agg in (kfold_aggregate.aggregate, jax_aggregate):
        with pytest.raises(SystemExit, match="do not match"):
            agg([str(a), str(c)])


def _jax_summary(exp_dir: str, epochs: str) -> dict:
    buf = io.StringIO()
    argv = ["summarize_run.py", exp_dir, "--epochs", epochs]
    with mock.patch.object(sys, "argv", argv), contextlib.redirect_stdout(buf):
        jax_summarize_run.main()
    return json.loads(buf.getvalue())


def test_summarize_run_matches_jax_script(folds, tmp_path):
    """On a fold's own scalars.jsonl, and on one with more epochs and an lr
    step (the port's trainer logs the JAX trainer's tags)."""
    longer = tmp_path / "run"
    longer.mkdir()
    with open(longer / "scalars.jsonl", "w") as f:
        for e in range(6):
            for tag, v in (("Val/Average/IOU", 0.1 * e + 0.01 * (e % 2)),
                           ("Val/Average/Di_score", 0.11 * e), ("Train/lr", 1e-4 if e < 4 else 5e-5),
                           ("Train/Average/IOU", 0.5)):
                f.write(json.dumps({"tag": tag, "value": v, "step": e, "time": 0.0}) + "\n")
    for exp_dir, epochs in ((folds[0], ""), (str(longer), "2,3")):
        got = summarize_run.summarize(exp_dir, epochs)
        assert got == _jax_summary(exp_dir, epochs)
        assert got["epochs_run"] >= 1 and got["best_epoch"] is not None
    out = tmp_path / "summary.json"
    summarize_run.main([str(longer), "--epochs", "2,3", "--out", str(out)])
    assert json.loads(out.read_text()) == _jax_summary(str(longer), "2,3")
    assert [t["epoch"] for t in json.loads(out.read_text())["lr_transitions"]] == [4]
