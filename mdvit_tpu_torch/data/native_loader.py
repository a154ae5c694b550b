"""ctypes bridge to the threaded npy loader (``csrc/npy_loader.cpp``), the
port's own copy of ``mdvit_tpu/data/native_loader.py``.

The library is built with ``g++`` at first use into ``build/native/<hash>/``
beside the package (the hash covers the source and the flags, so an edited
source rebuilds), like the CUDA kernels (``ops/kernels.py``). A failed build
raises. ``batch_load_u8`` returns None when a file does not match the corpus
contract, and the caller then loads file by file with numpy, as in the JAX
package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "npy_loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libnpy_loader.so"


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if ``g++`` fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"libnpy_loader.{os.getpid()}.tmp.so")
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.npy_batch_load.restype = ctypes.c_int
        lib.npy_batch_load.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def batch_load_u8(paths: list[str], item_shape: tuple,
                  n_threads: int = 8) -> np.ndarray | None:
    """N same-shaped uint8 npy files as one (N, *item_shape) array; None if a
    file does not match (the caller falls back to numpy)."""
    lib = get_lib()
    n = len(paths)
    item_bytes = int(np.prod(item_shape))
    out = np.empty((n,) + tuple(item_shape), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.npy_batch_load(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                            item_bytes, 1, n_threads)
    return out if rc == 0 else None
