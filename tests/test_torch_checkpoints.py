"""The port's two-phase checkpoint writer (``mdvit_tpu_torch/train/
checkpoints.py``): the cases of ``tests/test_checkpoints.py`` on
``torch.save`` files. At every instant either the final file or its complete
``.w`` sibling exists, and a reader takes the newer."""
import os

import pytest
import torch

from mdvit_tpu_torch.models.registry import build_mdvit
from mdvit_tpu_torch.train import checkpoints as ckpt
from mdvit_tpu_torch.train.trainer import results_table

torch.set_num_threads(2)


def _state(v):
    return {"model": {"w": torch.full((3,), float(v))}, "optimizer": {"mu": torch.ones(3)},
            "step": v, "epoch": v - 1, "max_iou": v / 10}


def _last(d):
    return os.path.join(d, ckpt.LAST)


def test_writer_swap_and_resume(tmp_path):
    d = str(tmp_path)
    w = ckpt.CheckpointWriter(d)
    w.save_last(_state(1))
    w.finalize()  # the pending save lives at last.pt.w until finalize
    assert os.path.isfile(_last(d)) and not os.path.exists(_last(d) + ".w")
    got = ckpt.try_load_last(d)
    assert got["step"] == 1 and got["epoch"] == 0
    w.save_last(_state(2))
    w.close()
    got = ckpt.try_load_last(d)
    assert got["step"] == 2 and got["epoch"] == 1
    stats = w.stats[ckpt.LAST]
    assert stats["bytes"] == os.path.getsize(_last(d))
    assert stats["write_seconds"] > 0 and stats["snapshot_seconds"] > 0


def test_restore_falls_back_to_pending_sibling(tmp_path):
    d = str(tmp_path)
    w = ckpt.CheckpointWriter(d)
    w.save_last(_state(3))
    w.wait()  # complete on disk, NOT yet swapped
    assert os.path.isfile(_last(d) + ".w") and not os.path.isfile(_last(d))
    got = ckpt.try_load_last(d)  # a kill before the swap: a new reader finds .w
    assert got["step"] == 3 and got["epoch"] == 2
    w.close()


def test_writer_clears_stale_tmp(tmp_path):
    d = str(tmp_path)
    stale = _last(d) + ".w.tmp"
    with open(stale, "wb") as f:
        f.write(b"half a checkpoint")
    ckpt.CheckpointWriter(d)
    assert not os.path.exists(stale)
    assert ckpt.try_load_last(d) is None


def test_best_fallback_resolution(tmp_path):
    d = str(tmp_path)
    model = torch.nn.Linear(2, 2)
    w = ckpt.CheckpointWriter(d)
    w.save_best(model)
    w.wait()  # killed-before-swap
    got = ckpt.load_best(d)
    torch.testing.assert_close(got["model"]["weight"], model.weight.detach(), rtol=0, atol=0)
    w.close()
    with pytest.raises(FileNotFoundError):
        ckpt.load_best(str(tmp_path / "none"))


def test_pending_sibling_preferred_over_swapped(tmp_path):
    """After a kill, last.pt.w is one save newer than last.pt."""
    d = str(tmp_path)
    w = ckpt.CheckpointWriter(d)
    w.save_last(_state(1))
    w.save_last(_state(2))  # finalizes epoch 0 → last.pt
    w.wait()  # epoch 1 complete at last.pt.w, not swapped
    assert ckpt.try_load_last(d)["epoch"] == 1
    w.close()


def test_init_promotes_leftover_pending_sibling(tmp_path):
    """A kill after the write finished but before the swap leaves a
    complete last.pt.w as the newest state; a new writer promotes it."""
    d = str(tmp_path)
    w = ckpt.CheckpointWriter(d)
    w.save_last(_state(5))
    w.wait()
    assert os.path.isfile(_last(d) + ".w")
    w2 = ckpt.CheckpointWriter(d)  # a new process after the kill
    assert os.path.isfile(_last(d)) and not os.path.exists(_last(d) + ".w")
    assert ckpt.try_load_last(d)["epoch"] == 4
    w2.save_last(_state(6))  # the promoted checkpoint survives a save cycle
    w2.close()
    assert ckpt.try_load_last(d)["epoch"] == 5


def test_bf16_model_round_trips_exactly(tmp_path):
    """Every parameter and buffer of a bf16-compute model comes back
    bit-equal in its own dtype, and the snapshot is taken at save time."""
    model = build_mdvit(img_size=32, device="cpu", dtype=torch.bfloat16,
                        embed_dims=(16, 16, 16, 16), num_layers=(1, 1, 1, 1))
    model.register_buffer("half_buf", torch.randn(5).to(torch.bfloat16))
    w = ckpt.CheckpointWriter(str(tmp_path))
    w.save_best(model)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # after the save: not in the checkpoint
    w.close()
    got = ckpt.load_best(str(tmp_path))["model"]
    assert set(got) == set(want)
    assert got["half_buf"].dtype == torch.bfloat16
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_results_table_total_row():
    """The Total row averages Dice and IoU over ALL datasets and sums the
    loss (a single dataset gives no NaN)."""
    res = {"a": {"loss": 1.0, "dice": 0.5, "iou": 0.4},
           "b": {"loss": 2.0, "dice": 0.7, "iou": 0.6}}
    rows = results_table(["a", "b"], res)
    assert [r["Name"] for r in rows] == ["a", "b", "Total"]
    total = rows[-1]
    assert abs(total["Di_score"] - 0.6) < 1e-9
    assert abs(total["IOU"] - 0.5) < 1e-9
    assert abs(total["loss"] - 3.0) < 1e-9
    one = results_table(["a"], {"a": res["a"]})[-1]
    assert abs(one["Di_score"] - 0.5) < 1e-9
