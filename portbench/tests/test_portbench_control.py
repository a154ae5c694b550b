"""The control on the card: the plain reference in TF32 (the precision
below the configurations' fp32 with TF32 off) in the system's place comes
out not correct against each cell's limits, at the cell's own size.
``python3 -m pytest portbench/tests/test_portbench_control.py`` on the
card (~1 min a cell); skips without one."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import calibrate, run

CELLS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    import mdvit_tpu_torch  # noqa: F401

    rec, = calibrate.readings(cell, [2**31 + 4242], 1, torch.device("cuda", 0))
    limits = json.loads((run.HERE / "limits" / f"{cell}.json").read_text())["limits"]
    assert run.judged(rec["program"], limits)[0], rec
    assert not run.judged(rec["control"], limits)[0], rec
