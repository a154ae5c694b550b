"""Scalar logging (``mdvit_tpu/utils/logging.py`` without its TensorBoard
sink): one JSON object per scalar in ``<log_dir>/scalars.jsonl``; with no
``log_dir`` (a data-parallel rank other than 0) it writes nothing."""
from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, log_dir: str | None):
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step), "time": time.time()}) + "\n")

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
