"""ImageNet-backbone grafting for TransFuse in the port
(``mdvit_tpu_torch/convert_torch_weights.py``, ``train/pretrained.py``, the
``pretrained_folder`` key) against the JAX path
(``scripts/convert_torch_weights.py`` + ``train/pretrained.apply_pretrained``),
on the CPU.

Random torchvision- and timm-shaped state dicts (tests/test_weight_converter.py's
schema modules, the timm file with its cls token and head too) are saved in
``tmp_path``; both sides convert them and graft them into TransFuse_S
(img 32) from the same seeded variables (tests/torch_zoo.py). The grafted
eval forwards agree within 1e-4·max(1, max|ref|), and the reports count the
same tensors.
"""
import copy
import re

import jax
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_serialize

from mdvit_tpu.train.pretrained import apply_pretrained as jax_apply_pretrained
from mdvit_tpu.train.pretrained import resize_grid_pos_embed as jax_resize_grid
from mdvit_tpu_torch import convert_torch_weights
from mdvit_tpu_torch.config import load_config
from mdvit_tpu_torch.models.registry import build_model
from mdvit_tpu_torch.models.transfuse import ResNetStem3Stages
from mdvit_tpu_torch.train.pretrained import apply_pretrained
from mdvit_tpu_torch.train.trainer import Trainer
from scripts.convert_torch_weights import convert_deit, convert_resnet
from tests.test_weight_converter import BasicBlock, Bottleneck, TorchDeiT, TorchResNet3Stages
from torch_zoo import case, check_maps, onehot

torch.set_num_threads(2)


def _checkpoints(folder):
    """A torchvision resnet34 and a timm deit_small (depth 12, as the
    checkpoint has; TransFuse keeps 8) state dict, random, as .pth files."""
    torch.manual_seed(7)
    resnet = TorchResNet3Stages(BasicBlock).eval()
    with torch.no_grad():
        for m in resnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    deit = TorchDeiT(embed_dim=384, depth=12, heads=6).eval()
    deit_sd = {**deit.state_dict(), "cls_token": torch.randn(1, 1, 384),
               "head.weight": torch.randn(1000, 384), "head.bias": torch.zeros(1000)}
    paths = {"resnet34": folder / "resnet34.pth", "deit_small": folder / "deit.pth"}
    torch.save(resnet.state_dict(), paths["resnet34"])
    torch.save({"model": deit_sd}, paths["deit_small"])
    return paths


def _convert_both(tmp_path, grid):
    """Each side's backbone files from the same checkpoints: JAX's msgpack
    trees in ``jax/``, the port's ``.pt`` files (through its CLI) in ``port/``."""
    ckpts = _checkpoints(tmp_path)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    sd = {k: v.numpy() for k, v in torch.load(ckpts["resnet34"]).items()}
    params, stats = convert_resnet(sd, "resnet34")
    (jax_dir / "resnet34.msgpack").write_bytes(
        msgpack_serialize({"params": params, "batch_stats": stats}))
    sd = {k: v.numpy() for k, v in torch.load(ckpts["deit_small"])["model"].items()}
    (jax_dir / "deit_small.msgpack").write_bytes(msgpack_serialize(
        {"params": convert_deit(sd, grid, depth=8),
         "meta": {"arch": "deit_small", "grid": list(grid)}}))
    for arch in ("resnet34", "deit_small"):
        convert_torch_weights.main(["--arch", arch, "--ckpt", str(ckpts[arch]),
                                    "--grid", *map(str, grid), "--out_dir", str(port_dir)])
    return jax_dir, port_dir


def _grafted_forwards(jax_dir, port_dir):
    model, variables, port = case("TransFuse_S")
    port = copy.deepcopy(port)
    params, stats, want_report = jax_apply_pretrained(
        variables["params"], variables["batch_stats"], "TransFuse_S", str(jax_dir), 32,
        model=model)
    got_report = apply_pretrained(port, "TransFuse_S", str(port_dir))
    x = np.random.RandomState(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    oh = onehot([0, 2])
    ref = jax.jit(lambda v, x, o: model.apply(v, x, o, train=False))(
        {"params": params, "batch_stats": stats}, x, oh)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(oh))
    check_maps([np.asarray(m) for m in ref["seg"]], [m.numpy() for m in out["seg"]])
    return want_report, got_report, params, port


def _counts(report):
    return tuple(int(n) for n in re.search(r"(\d+) tensors grafted, (\d+) skipped",
                                           report).groups())


def test_grafted_forward_matches_jax(tmp_path):
    jax_dir, port_dir = _convert_both(tmp_path, (2, 2))
    want, got, params, port = _grafted_forwards(jax_dir, port_dir)
    assert _counts(got) == _counts(want) and _counts(got)[1] == 0
    assert "resnet34.pt" in got and "deit_small.pt" in got
    np.testing.assert_array_equal(port.transformer.pos_embed.detach().numpy(),
                                  np.asarray(params["transformer"]["pos_embed"]))


def test_pos_embed_regrid_matches_jax(tmp_path, capsys):
    """Files converted for an 8×8 grid, a model at 2×2: both re-resize the
    position embedding at load."""
    jax_dir, port_dir = _convert_both(tmp_path, (8, 8))
    want, got, params, port = _grafted_forwards(jax_dir, port_dir)
    assert capsys.readouterr().out.count("re-resized") == 2
    assert _counts(got) == _counts(want)
    blob = torch.load(port_dir / "deit_small.pt")
    expect = jax_resize_grid(blob["state_dict"]["pos_embed"].numpy(), (8, 8), (2, 2))
    np.testing.assert_allclose(port.transformer.pos_embed.detach().numpy(), expect, atol=1e-6)


def test_grid_is_the_models(tmp_path):
    """A 32×48 model's grid (2, 3), not the square one of its img_size
    option (TransFuse_L_384's case)."""
    _, port_dir = _convert_both(tmp_path, (2, 2))
    port = build_model("TransFuse_S", img_size=(32, 48), device="cpu")
    report = apply_pretrained(port, "TransFuse_S", str(port_dir))
    blob = torch.load(port_dir / "deit_small.pt")
    expect = jax_resize_grid(blob["state_dict"]["pos_embed"].numpy(), (2, 2), (2, 3))
    np.testing.assert_allclose(port.transformer.pos_embed.detach().numpy(), expect, atol=1e-6)
    assert "grafted" in report


def test_non_transfuse_and_missing_files_are_noops(tmp_path):
    model = build_model("UTNet", device="cpu", base_chan=4, reduce_size=2)
    before = copy.deepcopy(model.state_dict())
    assert apply_pretrained(model, "UTNet", str(tmp_path)) is None
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    port = copy.deepcopy(case("TransFuse_S")[2])
    before = copy.deepcopy(port.state_dict())
    report = apply_pretrained(port, "TransFuse_S", str(tmp_path))
    assert "no resnet34/deit_small files" in report
    assert apply_pretrained(port, "TransFuse_S", "") is None
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in before.items())


@pytest.mark.parametrize("arch,block", [("resnet34", BasicBlock), ("resnet50", Bottleneck)])
def test_resnet_conversion_is_torchvision_forward(arch, block):
    """The converted tensors set every tensor of the port's ResNet branch
    (strict load), whose eval forward is the torchvision module's."""
    torch.manual_seed(1)
    tm = TorchResNet3Stages(block).eval()
    blob = convert_torch_weights.convert(arch, tm.state_dict())
    pm = ResNetStem3Stages(arch).eval()
    pm.load_state_dict(blob["state_dict"])
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        want = tm(x)
        got = pm(x.permute(0, 2, 3, 1))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.permute(0, 2, 3, 1), rtol=1e-4, atol=1e-4)


def test_trainer_grafts_pretrained_folder(tmp_path, capsys):
    """``pretrained_folder`` in the config: the Trainer's model starts from
    the backbones, and the report is printed."""
    _, port_dir = _convert_both(tmp_path, (2, 2))
    sizes = {n: [4, 2] for n in ("isic2018", "PH2", "DMF", "SKD")}
    cfg = load_config(overrides={
        "device": "cpu", "debug": True, "model": "TransFuse_S",
        "pretrained_folder": str(port_dir),
        "data": {"img_size": 32, "synthetic": True, "synthetic_sizes": sizes},
        "train": {"num_epochs": 1, "batch_size": 1}, "tpu": {"compute_dtype": "float32"}})
    tr = Trainer(cfg, str(tmp_path / "exp"))
    assert "tensors grafted, 0 skipped" in capsys.readouterr().out
    blob = torch.load(port_dir / "resnet34.pt")
    assert torch.equal(tr.model.resnet.conv1.weight, blob["state_dict"]["conv1.weight"])
