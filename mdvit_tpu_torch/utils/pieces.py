"""Small cross-cutting utilities, the port's own copy of
``mdvit_tpu/utils/pieces.py``: ``DotDict``, ``flatten_dict``, ``AvgMeter``
and ``load_yaml``.

``load_yaml`` reads JSON text without PyYAML (the trainer writes
``exp_config.yml`` as JSON, which YAML readers accept) and imports ``yaml``
only for a file that is not JSON.
"""
from __future__ import annotations

import json
from typing import Any, Iterator, Mapping


class DotDict(dict):
    """A dict whose items are also reachable as attributes, recursively
    (``config.train.optimizer.mode``). Missing keys raise
    ``AttributeError``, so typos in config access fail loudly."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: dict[str, Any] = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = self._wrap(value)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, DotDict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for key, value in self.items():
            if isinstance(value, DotDict):
                out[key] = value.to_dict()
            elif isinstance(value, (list, tuple)):
                out[key] = type(value)(
                    v.to_dict() if isinstance(v, DotDict) else v for v in value)
            else:
                out[key] = value
        return out


def read_yaml(path: str) -> Any:
    """The parsed content of a YAML file; JSON text needs no PyYAML."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml  # only for a file that is not JSON

        return yaml.safe_load(text)


def load_yaml(path: str) -> DotDict:
    return DotDict(read_yaml(path))


def flatten_dict(d: Mapping[str, Any], prefix: str = "",
                 sep: str = ".") -> Iterator[tuple[str, Any]]:
    for key, value in d.items():
        full = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from flatten_dict(value, full, sep)
        else:
            yield full, value


class AvgMeter:
    """Running average meter (reference ``Utils/pieces.py:76``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
