"""The port's serving export (``mdvit_tpu_torch/export.py``,
``torch.export``) on the CPU.

A narrow MDViT (Sup gate, MLPFM debranches) and a narrow BASE_DSN (the DSN
norms' per-domain gathers) at the tiny widths of tests/torch_family.py,
img 32, seeded flax variables carried into the port by
``from_jax_variables``: the exported program, saved and loaded, runs the
plain versions through ``torch.ops.mdvit.*`` and gives the live
``predict.make_forward``'s probabilities within 1e-6, and JAX's
``scripts/predict.py:make_forward``'s within the logit-scale tolerance of
tests/test_torch_mdvit.py (1e-4 of the largest logit, over the sigmoid's
largest slope of 1/4). Then the CLI, ``--check`` included, on an
experiment dir of the port's trainer.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu_torch import export
from mdvit_tpu_torch.config import load_config, save_config
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.data.preprocess import normalize
from mdvit_tpu_torch.models.base import split_seg
from mdvit_tpu_torch.models.registry import build_mdvit
from mdvit_tpu_torch.ops import kernels
from mdvit_tpu_torch.predict import make_forward
from mdvit_tpu_torch.train.trainer import build_model_from_config
from scripts.predict import make_forward as jax_make_forward
from torch_family import TINY, jax_model, onehot, port_model, random_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, B = 32, 4
DOMAINS = [2, 0, 3, 1]
LIVE_TOL = 1e-6      # the same plain versions, called by the program or by Python
REL_TOL = 1e-4       # tests/test_torch_mdvit.py: port against JAX, of the logit scale


def _models(row: str):
    """(flax module, its variables, the port's model with them)."""
    x0, oh0 = jnp.zeros((B, IMG, IMG, 3)), jnp.asarray(onehot(DOMAINS))
    if row == "MDViT":
        model = JaxMDViT(img_size=IMG, adapt="Sup", num_domains=4, **TINY)
        variables = random_variables(model, x0, oh0)
        port = build_mdvit(img_size=IMG, num_domains=4, device="cpu", **TINY)
        port.load_state_dict(from_jax_variables(variables))
        return model, variables, port
    model = jax_model(row, IMG)
    variables = random_variables(model, x0, oh0)
    return model, variables, port_model(row, variables, IMG)


@pytest.fixture(scope="module", params=["MDViT", "BASE_DSN"])
def case(request, tmp_path_factory):
    row = request.param
    model, variables, port = _models(row)
    rs = np.random.RandomState(3)
    x = rs.randint(0, 256, (B, IMG, IMG, 3)).astype(np.float32)
    oh = onehot(DOMAINS)
    path = str(tmp_path_factory.mktemp(row) / "model.pt2")
    torch.export.save(export.export_serving(port, B, IMG, 4), path)
    xt, oht = torch.from_numpy(x), torch.from_numpy(oh)
    kernels.reset_launches()
    program = export.load(path)
    got = export.run(program, xt, oht).numpy()
    live = make_forward(port)(xt, oht).numpy()
    with torch.no_grad():
        logits = split_seg(port(normalize(xt), oht, train=False)["seg"])[0]
    want = np.asarray(jax.jit(jax_make_forward(model, mkd=row == "MDViT"))(variables, x, oh))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    return {"got": got, "live": live, "jax": want, "targets": targets,
            "logit_scale": logits.abs().max().item(), "launches": dict(kernels.LAUNCHES)}


def test_loaded_program_matches_the_live_forward(case):
    assert case["got"].shape == (B, IMG, IMG) and np.isfinite(case["got"]).all()
    np.testing.assert_allclose(case["got"], case["live"], rtol=0, atol=LIVE_TOL)
    # CPU tensors: the ops ran their plain versions, no kernel launched
    assert not any(case["launches"].values())


def test_loaded_program_matches_jax(case):
    np.testing.assert_allclose(case["got"], case["jax"], rtol=0,
                               atol=REL_TOL * case["logit_scale"] / 4)


def test_program_calls_the_custom_ops(case):
    targets = case["targets"]
    blocks = 2 * sum(TINY["num_layers"])  # encoder and decoder blocks
    for name in ("factorized_attention", "cpe_conv", "crpe_conv"):
        assert sum(t == f"mdvit.{name}.default" for t in targets) == blocks, name


def test_export_cli_check(tmp_path):
    """``python -m mdvit_tpu_torch.export --ckpt_dir EXP --check`` on an
    experiment dir (``exp_config.yml`` and ``best.pt``) exits 0."""
    exp = tmp_path / "exp"
    exp.mkdir()
    cfg = load_config(overrides={"device": "cpu", "model": "BASE_DSN",
                                 "model_adapt": {"adapt_method": False},
                                 "data": {"img_size": IMG}, "model_kwargs": dict(TINY),
                                 "tpu": {"compute_dtype": "float32"}})
    save_config(cfg, str(exp / "exp_config.yml"))
    model = build_model_from_config(cfg, torch.device("cpu"))
    torch.save({"model": model.state_dict()}, exp / "best.pt")
    out = tmp_path / "model.pt2"
    proc = subprocess.run(
        [sys.executable, "-m", "mdvit_tpu_torch.export", "--ckpt_dir", str(exp), "--out",
         str(out), "--batch_size", "2", "--device", "cpu", "--check"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "check ok" in proc.stdout and out.stat().st_size > 0
