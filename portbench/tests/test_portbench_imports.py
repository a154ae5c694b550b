"""No module of JAX or of the JAX package is loaded by a run, compared by
whole top-level names (the system's name begins with the JAX package's)."""
from __future__ import annotations

import os
import subprocess
import sys

from portbench import run


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"mdvit_tpu_torch": None, "mdvit_tpu_torch.ops": None,
                                         "jaxtyping": None, "numpy": None})
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mdvit_tpu.models", None)
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert run.forbidden_modules() == ["jax", "mdvit_tpu"]


def test_a_run_loads_no_jax():
    """Every module a run imports (harness, traffic kinds, readers, counts,
    reference, the system's entry points), then a tiny run of each cell on
    the CPU: nothing of JAX or of the JAX package in ``sys.modules``."""
    code = (
        "import json\n"
        "from portbench import run, calibrate, flops  # noqa: F401\n"
        "from portbench.tests import tiny\n"
        "for cell in tiny.CELLS:\n"
        "    bench, cfg, mix = tiny.cell(cell)\n"
        "    for traced in (False, True):\n"
        "        run.run_cell(bench, cell, cfg, mix, 7, 0.2, traced, 'cpu')\n"
        "    for m in run.metrics_of(bench, cell, 'per_layer'):\n"
        "        run.reader(m['name'])\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=900, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
