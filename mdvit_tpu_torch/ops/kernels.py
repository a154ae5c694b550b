"""Build, load and count the hand-written CUDA kernels of the port.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs at
first use, one ``nvcc`` per source, all started together, into
``build/kernels/<hash>/`` beside the package (the hash covers the sources and
the flags, so an edited source rebuilds). Nothing here runs at import: the CPU
tests import every module of the package.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels (``reset_launches`` sets every count to 0).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"

# library name -> source file; each library holds the kernels of one source
SOURCES = {
    "factorized_attention": "factorized_attention.cu",
    "dwconv": "dwconv.cu",
    "dropout": "dropout.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"factorized_attention": 0, "cpe_conv": 0, "crpe_conv": 0,
            "factorized_attention_bwd": 0, "cpe_conv_bwd": 0, "crpe_conv_bwd": 0,
            "dropout": 0}

# output rows of a tile of the tiled depthwise-conv kernels (``kTileH`` in dwconv.cu)
TILE_H = 8

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict = {}


def dwconv_weight_tiles(batch: int, height: int, width: int) -> int:
    """Tiles of the CPE and CRPE backwards, one partial dw/db row each:
    B·⌈H/8⌉·⌈W/TW⌉, TW = 16, or 8 for images at most 8 wide (``tile_w`` in
    dwconv.cu)."""
    tw = 16 if width > 8 else 8
    return batch * -(-height // TILE_H) * -(-width // tw)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(log: str) -> list[dict]:
    """Per-kernel registers, static shared memory and spills from ``-Xptxas -v``."""
    out: list[dict] = []
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            out.append({"kernel": m.group(1), "registers": None,
                        "smem_bytes": 0, "spill_stores": None,
                        "spill_loads": None})
            continue
        if not out:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[-1]["spill_stores"] = int(m.group(2))
            out[-1]["spill_loads"] = int(m.group(3))
            continue
        m = _PTXAS_USED.search(line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            out[-1]["smem_bytes"] = int(m.group(2) or 0)
    return out


def build() -> dict:
    """Compile every missing library (in parallel) and return build info:
    seconds, the build directory and the ptxas report per library."""
    with _lock:
        if BUILD_INFO:
            return BUILD_INFO
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name, src in SOURCES.items():
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
        logs = {name: proc.communicate()[0] for name, (proc, _, _) in procs.items()}
        for name, (proc, tmp, lib) in procs.items():
            (out_dir / f"{name}.ptxas.log").write_text(logs[name])
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{logs[name]}")
            os.replace(tmp, lib)
        info = {"seconds": time.perf_counter() - t0, "dir": str(out_dir),
                "built": sorted(procs), "ptxas": {}}
        for name in SOURCES:
            log_file = out_dir / f"{name}.ptxas.log"
            log = log_file.read_text() if log_file.exists() else ""
            info["ptxas"][name] = parse_ptxas(log)
        BUILD_INFO.update(info)
        return BUILD_INFO


_ARGTYPES = {
    "mdvit_factorized_attention_fwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p]),
    "mdvit_cpe_conv_fwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_int, ctypes.c_void_p]),
    "mdvit_crpe_conv_fwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_int] * 2 + [ctypes.c_int, ctypes.c_void_p]),
    "mdvit_factorized_attention_bwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p]),
    "mdvit_factorized_attention_workspace": [ctypes.c_int] * 3,
    "mdvit_factorized_attention_partial": [ctypes.c_int] * 2,
    "mdvit_factorized_attention_chunk_rows": [ctypes.c_int] * 2,
    "mdvit_factorized_attention_fwd_partials": (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]),
    "mdvit_factorized_attention_fwd_apply": (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p]),
    "mdvit_factorized_attention_bwd_partials": (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]),
    "mdvit_factorized_attention_bwd_apply": (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p]),
    "mdvit_cpe_conv_bwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_int, ctypes.c_void_p]),
    "mdvit_crpe_conv_bwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_longlong, ctypes.c_int] * 2 + [ctypes.c_int, ctypes.c_void_p]),
    "mdvit_dropout": (
        [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_int]
        + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p]),
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), argtypes declared."""
    lib = _libs.get(name)
    if lib is None:
        info = build()
        lib = ctypes.CDLL(str(Path(info["dir"]) / f"lib{name}.so"))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def dtype_code(dtype: torch.dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def check_status(fn: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {status}")
