"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by its name in ``BENCHMARK.json`` (the checkout's root):
its configuration's file, and its traffic mix, ``portbench/traffic/<mix>.json``,
whose ``kind`` names its code, ``portbench/traffic/<kind>.py``. Set-up (the
kind's: the system built, weights and inputs made on the card from the
seed, every shape warmed up) runs from the process's start; then the window,
untraced (``--trace 0``: the cell's end-to-end metrics) or traced
(``--trace 1``: two windows of the mix's ``trace_work`` steps or calls
under ``torch.profiler``, the device's ops alone and then with the host's,
and the cell's per-layer metrics, each read by
``portbench/metrics/<name>.py``); then, with the system's state freed, the
check against the plain reference. The last lines on standard error give
each number compared beside its limit (``portbench/limits/<cell>.json``),
and the last line on standard output is the result.

Exits with 2, printing no result, without enough CUDA devices; with 3 when
a module of JAX or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import data  # noqa: E402
from portbench.reference.train import set_precision  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the port's kernel builds stay in the checkout (build/kernels, the
# system's own); compile caches of PyTorch's own at fixed paths beside them
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "portbench" / "triton",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "portbench" / "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mdvit_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``mdvit_tpu_torch`` is not ``mdvit_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_spec(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(benchmark, workload entry, configuration, traffic mix) of a cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer metrics:
    those listing it, or listing no cells (a per-layer one then where the
    cell reports what it moves)."""
    e2e = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])
            and (kind == "end_to_end" or m["moves"] in e2e)]


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", root / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def peaks_of(kind: str, precision: str) -> dict | None:
    table = json.loads((HERE / "peaks.json").read_text()).get(kind)
    if table is None:
        return None
    return {"flop_per_s": table[precision], "bytes_per_s": table["bytes_per_s"]}


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every one is finite and
    at most its limit."""
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, compared


def run_cell(bench: dict, name: str, cfg: dict, mix: dict, seed: int, seconds: float,
             traced: bool, device, chips: int = 1) -> dict:
    """Set-up, window, check of one cell on ``device``: the result line.
    Every CUDA device the cell uses has been looked for already."""
    import torch

    from portbench import trace

    cuda = torch.device(device).type == "cuda"
    module = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    traffic = module.Traffic(cfg, mix, seed, device, trace.Spans(traced))
    traffic.setup()
    flops = traffic.flops() if traced else None
    gc.collect()  # set-up's garbage, not the window's pauses
    data.sync(device)
    setup_s = time.perf_counter() - START
    if traced:
        with trace.recording(host=False) as device_prof:
            result = traffic.window(steps=mix["trace_work"])
        with trace.recording(host=True) as host_prof:
            traffic.window(steps=mix["trace_work"])
    else:
        result = traffic.window(seconds=seconds)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": chips,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))
           if cuda else 0}
    if traced:
        precision = "tf32" if cfg["tf32"] else cfg["dtype"]
        window = trace.TracedWindow(device_prof[0], host_prof[0], result, flops,
                                    peaks_of(kind, precision),
                                    torch.finfo(getattr(torch, cfg["dtype"])).bits // 8)
        del device_prof, host_prof
        metrics = {}
        for m in metrics_of(bench, name, "per_layer"):
            value = reader(m["name"])(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=window.busy_s, window_s=window.window_s)
        breakdown = {"breakdown": window.breakdown()}
        del window
    else:
        measured = {**module.Traffic.end_to_end(result), "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, name, "end_to_end")}
        breakdown = {}
    traffic.release()
    if cuda:
        torch.cuda.empty_cache()
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())["limits"]
    ok, compared = judged(traffic.check(), limits)
    return {"correct": ok, "attempted": result["work"], "failed": 0, "metrics": metrics,
            "device": dev, **breakdown, "card": card() if cuda else "cpu",
            "compared": compared}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)

    import torch

    bench, cell, cfg, mix = cell_spec(args.workload)
    chips = cell["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s), {found} available",
              file=sys.stderr)
        return 2
    import mdvit_tpu_torch  # noqa: F401  (sets cuBLAS's workspace before any handle)

    set_precision(tf32=False)
    line = run_cell(bench, args.workload, cfg, mix, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), chips)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
