"""Checkpoints with ``torch.save``: the best model by mean IoU and the full
train state for resume, with the two-phase protocol of
``mdvit_tpu/train/checkpoints.py``.

A save first copies the state to host memory (the caller may change it
right after), then a background thread writes ``<path>.w.tmp`` and renames it
to ``<path>.w``, so ``<path>.w`` appears only when complete. The finished
``.w`` is swapped into ``<path>`` before the next save (``finalize``). At every
instant ``<path>`` or ``<path>.w`` holds a complete checkpoint; a reader
prefers ``<path>.w``, one save newer. A new writer deletes stale ``.tmp``
files and promotes a leftover complete ``.w``: the state a killed process
wrote last.

``best.pt`` holds ``{"model": state_dict}``; ``last.pt`` also the
optimizer, the scheduler, both generators' states, ``step``, ``epoch`` and
``max_iou``. Tensors keep their dtypes.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any

import torch

BEST, LAST = "best.pt", "last.pt"


def to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _resolve(path: str) -> str | None:
    """A complete checkpoint for ``path``: the pending ``.w`` sibling when
    present (one save newer), else ``path`` itself."""
    for p in (path + ".w", path):
        if os.path.isfile(p):
            return p
    return None


def load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointWriter:
    """Two-phase checkpoint writer, one per experiment dir; the write runs
    on a background thread. ``stats[name]`` records the last save of each
    file: ``snapshot_seconds`` (the copy to host memory, on the caller's
    thread), ``write_seconds`` (``torch.save`` on the writer's thread) and
    ``bytes``."""

    def __init__(self, exp_dir: str):
        self.exp_dir = exp_dir
        self._pending: str | None = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.stats: dict[str, dict] = {}
        if os.path.isdir(exp_dir):
            for name in os.listdir(exp_dir):
                if name.endswith(".w.tmp"):  # a write a killed process left
                    os.remove(os.path.join(exp_dir, name))
            for base in (BEST, LAST):
                path = os.path.join(exp_dir, base)
                if os.path.isfile(path + ".w"):
                    os.replace(path + ".w", path)

    def _write(self, obj: Any, w: str, stats: dict) -> None:
        try:
            t0 = time.perf_counter()
            torch.save(obj, w + ".tmp")
            os.replace(w + ".tmp", w)
            stats.update(write_seconds=time.perf_counter() - t0, bytes=os.path.getsize(w))
        except BaseException as exc:  # re-raised on the caller's thread
            self._error = exc

    def _save(self, base: str, obj: Any) -> None:
        self.finalize()
        path = os.path.join(self.exp_dir, base)
        if os.path.isfile(path + ".w"):
            os.remove(path + ".w")
        t0 = time.perf_counter()
        host = to_host(obj)
        stats = self.stats[base] = {"snapshot_seconds": time.perf_counter() - t0}
        self._thread = threading.Thread(target=self._write, args=(host, path + ".w", stats),
                                        daemon=True)
        self._thread.start()
        self._pending = path

    def wait(self) -> None:
        """Wait for the write in flight (complete at ``.w``, not swapped)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def finalize(self) -> None:
        """Wait for the write in flight and swap it into its final name."""
        self.wait()
        if self._pending is None:
            return
        path, self._pending = self._pending, None
        if os.path.isfile(path + ".w"):
            os.replace(path + ".w", path)

    def save_best(self, model: torch.nn.Module) -> None:
        self._save(BEST, {"model": model.state_dict()})

    def save_last(self, state: dict) -> None:
        """``state``: the trainer's full state (``Trainer.full_state``)."""
        self._save(LAST, state)

    def close(self) -> None:
        self.finalize()


def load_best(exp_dir: str) -> dict:
    path = _resolve(os.path.join(exp_dir, BEST))
    if path is None:
        raise FileNotFoundError(os.path.join(exp_dir, BEST))
    return load(path)


def try_load_last(exp_dir: str) -> dict | None:
    path = _resolve(os.path.join(exp_dir, LAST))
    return None if path is None else load(path)
