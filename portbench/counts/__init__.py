"""FLOPs and bytes of each custom op of the system under test, one file an
op named as the op without its namespace (``mdvit::cpe_conv`` →
``cpe_conv.py``): ``count(shapes, args, elem_bytes) → (flops, bytes)`` from
the call's argument shapes and scalar arguments. Bytes count each input
read once and each output written once, whatever the kernels read again;
FLOPs count what these inputs need. A kernel added later brings its own
file."""
from __future__ import annotations

import importlib


def counter(op: str):
    """The ``count`` function of the op ``op`` (``namespace::name``)."""
    return importlib.import_module(f"portbench.counts.{op.split('::')[-1]}").count
