"""The plain reference agrees with the system's CPU path at tiny widths,
from the same weights, inputs and seeds; and it imports nothing of the
system, nor JAX, nor the JAX package."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from portbench import data, system, trace, weights
from portbench.reference import rng
from portbench.reference import train as ref_train
from portbench.tests import tiny
from portbench.traffic import train

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def _cfg(name: str) -> dict:
    return tiny.cell(f"{name}.train.d4b16")[1]


@pytest.mark.parametrize("name", ["mdvit", "base"])
def test_serving_maps_agree(name):
    from mdvit_tpu_torch.predict import make_forward

    cfg = _cfg(name)
    model = system.build(cfg, "cpu")
    ref = ref_train.build(cfg)
    ref.load_state_dict(weights.make_state(ref, torch.Generator().manual_seed(3), "cpu"))
    (x, oh), = data.pool(11, 1, 8, cfg["img_size"], 4, "cpu")
    state = weights.calibrated(ref, x, oh, rng.normalize)
    model.load_state_dict(state)
    got, want = make_forward(model)(x, oh), ref_train.serve(ref, x, oh)
    assert (got - want).abs().max() < 1e-4


@pytest.mark.parametrize("name", ["mdvit", "base"])
def test_train_steps_agree(name):
    """Three steps from one state: losses to fp32 rounding, the first
    gradient and the change over the steps leaf by leaf."""
    cfg = _cfg(name)
    mix = {**tiny.cell(f"{name}.train.d4b16")[2], "compared_steps": 3}
    t = train.Traffic(cfg, mix, 2**31 + 99, "cpu", trace.Spans(False))
    t.setup()
    t.release()
    numbers = t.check()
    assert numbers["loss"] < 1e-5 and numbers["grad"] < 1e-3 and numbers["update"] < 1e-2, numbers


def test_reference_draws_its_masks_as_the_system_does():
    from mdvit_tpu_torch.ops import layers

    gen_a, gen_b = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    x = torch.ones(6, 5, 7)
    want = layers.fast_dropout(x, 0.1, True, gen_a)
    got = rng.dropout(x, 0.1, rng.SeedTape(gen_b).next(), 0)
    assert torch.equal(got, want)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_system(path):
    assert not _imports(path) & {"mdvit_tpu_torch", "mdvit_tpu", "jax", "jaxlib", "flax", "optax"}
