"""The port's Trainer and CLI under data parallelism on the CPU, in gloo
ranks that ``tests/torch_dp.py`` spawns: ``evaluate`` in two ranks equals
one process's (``tests/test_trainer_dp.py::
test_evaluate_metric_protocol_mesh_invariant``), on both eval paths, and a
CLI run in two ranks writes its files from rank 0 alone and resumes
bit-exactly."""
import os

import numpy as np
import torch

import torch_dp
from mdvit_tpu_torch.config import load_config
from mdvit_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

TINY_MODEL = {"num_layers": [1, 1, 1, 1], "embed_dims": [8, 8, 8, 8],
              "mlp_ratios": [1, 1, 1, 1], "num_heads": [8, 8, 8, 8]}
# test_trainer_dp.py's: 7 test images a domain in batches of 5 (a full batch
# and a tail of 2), which divides neither the split nor the ranks
EVAL = {"device": "cpu", "debug": True,
        "data": {"img_size": 16, "synthetic": True,
                 "synthetic_sizes": {k: [6, 7] for k in ("isic2018", "PH2", "DMF", "SKD")}},
        "train": {"num_epochs": 1, "batch_size": 2}, "test": {"batch_size": 5},
        "model_kwargs": TINY_MODEL, "tpu": {"compute_dtype": "float32"}}
# the files a CLI run writes into its experiment dir
EXP_FILES = ("exp_config.yml", "scalars.jsonl", "best.pt", "last.pt", "best_meta.json",
             "test_results.csv")


def test_evaluate_in_two_ranks_equals_one_process(tmp_path):
    """Each batch of 5 is padded to 6 and split 3 + 3; the counts and the
    loss sums are summed over the ranks. Identically seeded weights; both
    eval paths (the split on the device, streamed from the host)."""
    want = {}
    for device_eval in (True, False):
        over = {**EVAL, "tpu": {**EVAL["tpu"], "device_eval": device_eval}}
        want[device_eval] = Trainer(load_config(overrides=over),
                                    str(tmp_path / "one")).evaluate("test")
    results = torch_dp.spawn(torch_dp.eval_worker, 2, tmp_path, EVAL, str(tmp_path / "two"),
                             str(tmp_path / "out"))
    for got in results:
        for device_eval, res in want.items():
            for name, metrics in res.items():
                for key, value in metrics.items():
                    np.testing.assert_allclose(got[device_eval][name][key], value,
                                               rtol=1e-5, atol=1e-6,
                                               err_msg=f"{device_eval} {name}/{key}")


def _same_bits(a, b, where=()) -> None:
    """Nested dicts and lists of tensors and numbers, bit-equal."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                  b.reshape(-1).view(torch.uint8)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_bits(a[k], b[k], where + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, where + (i,))
    else:
        assert a == b, where


def test_cli_in_two_ranks_writes_from_rank_0_and_resumes(tmp_path):
    """One CLI epoch in two ranks: rank 1 writes nothing and the experiment
    dir holds every file; a second run resumes from ``last.pt`` on both
    ranks with the first run's full state (parameters, optimizer, scheduler,
    generators, step) bit-equal, and trains epoch 1."""
    config = tmp_path / "tiny.yml"
    config.write_text(
        "device: cpu\n"
        "data: {img_size: 16, synthetic: true, synthetic_sizes: {isic2018: [6, 3], "
        "PH2: [6, 3], DMF: [6, 3], SKD: [6, 3]}}\n"
        "train: {batch_size: 2, save_last_every: 1}\n"
        "test: {batch_size: 2}\n"
        "model_kwargs: {num_layers: [1, 1, 1, 1], embed_dims: [8, 8, 8, 8], "
        "mlp_ratios: [1, 1, 1, 1], num_heads: [8, 8, 8, 8]}\n"
        "tpu: {compute_dtype: float32}\n")
    exp = tmp_path / "exp"
    results = torch_dp.spawn(torch_dp.cli_worker, 2, tmp_path, str(config), str(exp),
                             str(tmp_path / "out"))
    assert results[1]["writes"] == []
    assert sorted(os.listdir(exp)) == sorted(EXP_FILES)
    for res in results:
        assert res["epochs"] == (0, 1, 6)  # 3 steps an epoch
        _same_bits(res["fitted"], res["resumed"])
    _same_bits(results[0]["fitted"], results[1]["fitted"])
