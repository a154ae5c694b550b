"""The port's MDViT_DSN (per-domain norms through the whole trunk), the
counterparts of tests/test_mdvit_dsn.py, on the CPU: the DSN wiring reaches
every norm of the trunk, grouped equals select in eval, a domain's samples
leave the other domains' norm slices and debranches without gradient, and
the reference's DSN names (``torch_mdvit_to_flax(dsn=True)``) cover the
port's ``state_dict`` both ways; and each norm mode against its flax module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.ops import norm as jax_norm
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.ops.norm import (DomainBatchNorm, DomainBatchNormDSN, DomainLayerNorm,
                                      DomainLayerNormDSN, NormSpec, make_bn, make_ln)
from mdvit_tpu_torch.models.registry import build_model
from scripts.convert_reference_mdvit import check_structure, torch_mdvit_to_flax
from torch_family import jax_model, onehot, random_variables

torch.set_num_threads(2)

TINY = dict(num_layers=(1, 1, 1, 1), embed_dims=(8, 16, 16, 24), mlp_ratios=(2, 2, 2, 2),
            num_heads=(8, 8, 8, 8))  # tests/test_mdvit_dsn.py
D, B, IMG = 4, 2, 32


@pytest.fixture(scope="module")
def model():
    m = build_model("MDViT_DSN", img_size=IMG, num_domains=D, device="cpu",
                    drop_rate=0.0, drop_path_rate=0.0, seed=3, **TINY)
    with torch.no_grad():  # norms away from their init, each domain its own
        gen = torch.Generator().manual_seed(4)
        for name, p in m.named_parameters():
            if ".bns." in name or "norms" in name or ".norm1s." in name or ".norm2s." in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return m


def _batch():
    x = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (D * B, IMG, IMG, 3)).astype(np.float32))
    return x, torch.from_numpy(onehot(np.repeat(np.arange(D), B)))


def test_dsn_wiring_is_pervasive(model):
    """Every norm of the trunk is per domain, with D slots; the debranches'
    norms are plain (each debranch is one domain's)."""
    trunk = [(n, m) for n, m in model.named_modules() if not n.startswith("debranch")]
    per_domain = [n for n, m in trunk if isinstance(m, (DomainBatchNormDSN,
                                                        DomainLayerNormDSN))]
    shared = [n for n, m in trunk if isinstance(m, (DomainBatchNorm, DomainLayerNorm))]
    # 2 stems + 4 patch embeds + 2 bridge + 4 conv_after BNs, 2 LNs in each of 8 blocks
    assert len(per_domain) == 12 + 16 and not shared, shared
    assert all(len(model.get_submodule(n)) == D for n in per_domain)
    deb = [m for n, m in model.named_modules() if n.startswith("debranch")]
    assert any(isinstance(m, DomainBatchNorm) for m in deb)
    assert not any(isinstance(m, (DomainBatchNormDSN, DomainLayerNormDSN)) for m in deb)


def test_dsn_grouped_equals_select_in_eval(model):
    x, oh = _batch()
    with torch.no_grad():
        grouped = model(x, oh, aux_mode="grouped")["seg"]
        select = model(x, oh, aux_mode="select")["seg"]
    torch.testing.assert_close(grouped[0], select[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grouped[1], select[1], rtol=1e-5, atol=1e-5)


def test_dsn_per_domain_gradient_isolation(model):
    """A loss on domain k's samples alone gives every other domain's norm
    slices, and the other debranches, exactly zero gradient."""
    k = 2
    x, oh = _batch()
    model.zero_grad()
    logits, aux = model(x, oh, train=True, aux_mode="grouped",
                        gen=torch.Generator().manual_seed(0))["seg"]
    lg, ag = logits.reshape(D, B, -1), aux.reshape(D, B, -1)
    (lg[k].square().sum() + ag[k].square().sum()).backward()
    touched = 0
    per_domain = [m for n, m in model.named_modules()
                  if isinstance(m, (DomainBatchNormDSN, DomainLayerNormDSN))]
    for norm in per_domain:
        for d, slot in enumerate(norm):
            for p in (slot.weight, slot.bias):
                if d != k:
                    assert p.grad is None or not p.grad.any()
                else:
                    touched += int(p.grad is not None and bool(p.grad.any()))
    assert touched >= len(per_domain)  # most of domain k's slices carry signal
    for d in range(D):
        moved = [p.grad is not None and bool(p.grad.any())
                 for p in model.debranch_module(d).parameters()]
        assert any(moved) if d == k else not any(moved), d
    model.zero_grad()


def test_dsn_names_match_the_reference_converter(model):
    """The port's MDViT_DSN ``state_dict`` goes through the reference
    converter (``torch_mdvit_to_flax(dsn=True)``) into a tree that
    ``check_structure`` matches against JAX MDViT_DSN's, and
    ``from_jax_variables`` brings it back bit-equal."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    converted = torch_mdvit_to_flax(sd, num_layers=TINY["num_layers"], num_domains=D,
                                    dsn=True)
    jmodel = jax_model("MDViT_DSN", IMG)
    like = random_variables(jmodel.clone(embed_dims=TINY["embed_dims"],
                                         mlp_ratios=TINY["mlp_ratios"]),
                            jnp.zeros((D, IMG, IMG, 3)), jnp.eye(D))
    check_structure(converted, like)
    back = from_jax_variables(jax.tree_util.tree_map(np.asarray, converted))
    assert back.keys() == model.state_dict().keys()
    for name, v in model.state_dict().items():
        assert torch.equal(back[name], v), name


def _bn_state(v, dsn: bool) -> dict:
    """A flax DomainBatchNorm's variables in the port's names."""
    leaves = {"weight": v["params"]["scale"], "bias": v["params"]["bias"],
              "running_mean": v["batch_stats"]["mean"], "running_var": v["batch_stats"]["var"]}
    if not dsn:
        return {k: torch.tensor(np.asarray(a)) for k, a in leaves.items()}
    return {f"{d}.{k}": torch.tensor(np.asarray(a[d]))
            for k, a in leaves.items() for d in range(D)}


@pytest.mark.parametrize("dsn,group_stats", [(True, True), (True, False), (False, False)],
                         ids=["dsn", "dsn_joint", "shared_joint"])
def test_batch_norm_modes_match_jax(dsn, group_stats):
    """``make_bn`` against ``DomainBatchNorm(affine_per_domain=stats_per_domain=
    dsn, group_stats)``: train-mode output and running stats (domain 3 absent:
    its DSN stats stay), then eval output, on a mixed (B, H, W, C) batch."""
    rs = np.random.RandomState(7)
    x = (3 * rs.standard_normal((6, 4, 5, 10)) + 1).astype(np.float32)
    oh = onehot([0, 2, 2, 1, 0, 1])
    jbn = jax_norm.DomainBatchNorm(10, num_domains=D, affine_per_domain=dsn,
                                   stats_per_domain=dsn, group_stats=group_stats)
    v = random_variables(jbn, jnp.asarray(x), jnp.asarray(oh), seed=8,
                         call_kw={"use_running_average": True})
    port = make_bn(10, NormSpec(D, dsn, group_stats))
    port.load_state_dict(_bn_state(v, dsn))
    xt, oht = torch.from_numpy(x), torch.from_numpy(oh)
    want, upd = jbn.apply(v, x, oh, use_running_average=False, mutable=["batch_stats"])
    np.testing.assert_allclose(port(xt, oht, train=True).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    for k, t in _bn_state(v, dsn).items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = jbn.apply(v, x, oh, use_running_average=True)
    np.testing.assert_allclose(port(xt, oht).detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_layer_norm_dsn_matches_jax():
    rs = np.random.RandomState(9)
    x = rs.standard_normal((6, 7, 12)).astype(np.float32)
    oh = onehot([3, 2, 2, 1, 0, 1])
    jln = jax_norm.DomainLayerNorm(12, num_domains=D, per_domain=True)
    v = random_variables(jln, jnp.asarray(x), jnp.asarray(oh), seed=10, call_kw={})
    port = make_ln(12, D, dsn=True)
    for d, slot in enumerate(port):
        slot.load_state_dict({"weight": torch.from_numpy(np.asarray(v["params"]["scale"][d])),
                              "bias": torch.from_numpy(np.asarray(v["params"]["bias"][d]))})
    want = jln.apply(v, x, oh)
    got = port(torch.from_numpy(x), torch.from_numpy(oh))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
