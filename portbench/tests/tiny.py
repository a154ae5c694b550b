"""Cells at tiny widths for the CPU tests: the cell's own configuration and
traffic mix with the widths, the image and the batches cut down."""
from __future__ import annotations

from portbench import run

WIDTHS = {"embed_dims": [16, 32, 40, 64], "num_layers": [1, 1, 1, 1],
          "mlp_ratios": [2, 2, 2, 2], "img_size": 64}
SIZES = {"per_domain_batch": 2, "per_domain_store": 4, "batch": 8, "pool": 2,
         "calibration_batch": 4, "compared_calls": 2, "trace_work": 2, "ahead": 2}
CELLS = ("mdvit.train.d4b16", "mdvit.serve.b256", "base.train.d4b16")


def cell(name: str, root=run.ROOT):
    """(benchmark, configuration, mix) of ``name`` at tiny widths."""
    bench, _, cfg, mix = run.cell_spec(name, root)
    return bench, {**cfg, **WIDTHS}, {**mix, **{k: v for k, v in SIZES.items() if k in mix}}
