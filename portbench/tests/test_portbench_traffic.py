"""Each traffic kind runs a few steps or calls at tiny widths on the CPU
(its check against the reference: test_portbench_reference,
test_portbench_faults)."""
from __future__ import annotations

import importlib

import pytest

from portbench import trace
from portbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traffic_runs_at_tiny_widths(cell):
    _, cfg, mix = tiny.cell(cell)
    module = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    t = module.Traffic(cfg, mix, 2**32 + 3, "cpu", trace.Spans(False))
    t.setup()
    result = t.window(steps=3)
    assert result["work"] == 3 and result["seconds"] > 0
    assert result["images"] == 3 * (mix.get("batch") or mix["per_domain_batch"] * 4)
    measured = module.Traffic.end_to_end(result)
    assert measured and all(v > 0 for v in measured.values())
    t.release()


def test_train_window_feeds_fresh_rows_each_step():
    """The first compared steps and the window take distinct rows of each
    domain's permutation, an epoch being store // batch steps."""
    from portbench import data

    epochs = data.Epochs(5, 4, 8, 2, "cpu")
    rows = [epochs.next() for _ in range(4)]
    for d in range(4):
        seen = [int(i) for r in rows for i in r[d]]
        assert sorted(seen) == list(range(8))
