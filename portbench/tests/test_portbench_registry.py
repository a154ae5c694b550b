"""The benchmark is driven by data: every name in BENCHMARK.json finds its
file, and a cell added as files is found without editing any file."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.counts import counter

ROOT = run.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert len(run.metrics_of(BENCH, w["name"], "end_to_end")) >= 2
        assert run.metrics_of(BENCH, w["name"], "per_layer")
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    bench, entry, cfg, mix = run.cell_spec(cell)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert (ROOT / "portbench" / "traffic" / f"{mix['kind']}.py").exists()
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    assert limits["limits"] and all(v > 0 for v in limits["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(run.reader(metric))


@pytest.mark.parametrize("op", ["mdvit::factorized_attention", "mdvit::factorized_attention_bwd",
                                "mdvit::cpe_conv", "mdvit::cpe_conv_bwd", "mdvit::crpe_conv",
                                "mdvit::crpe_conv_bwd"])
def test_every_custom_op_has_a_count(op):
    assert callable(counter(op))


def test_a_cell_added_as_files_runs_without_editing_any_file(tmp_path):
    """A copy of the benchmark gains a cell: a traffic mix file, a limits
    file and the cell's entry in BENCHMARK.json, the registry every cell is
    named in. The copy's harness, no file of it edited, runs the cell."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "base.train.d4b2", "config": "base", "traffic": "train.d4b2", "chips": 1,
         "why": "a throwaway cell"}]
    bench["end_to_end"] = [
        {**m, "workloads": m["workloads"] + ["base.train.d4b2"]}
        if m["name"] == "train_img_per_s" else m for m in BENCH["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "portbench" / "traffic" / "train.d4b16.json").read_text())
    (tmp_path / "portbench" / "traffic" / "train.d4b2.json").write_text(
        json.dumps({**mix, "per_domain_batch": 2, "per_domain_store": 4}))
    (tmp_path / "portbench" / "limits" / "base.train.d4b2.json").write_text(
        (ROOT / "portbench" / "limits" / "base.train.d4b16.json").read_text())
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        "assert run.ROOT == __import__('pathlib').Path.cwd(), run.ROOT\n"
        "bench, cfg, mix = tiny.cell('base.train.d4b2', run.ROOT)\n"
        "line = run.run_cell(bench, 'base.train.d4b2', cfg, mix, 2**33 + 1, 0.5, False, 'cpu')\n"
        "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}:{ROOT}",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"train_img_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())
