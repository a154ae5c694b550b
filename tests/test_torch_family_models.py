"""The port's model family against the JAX package's, forward, on the CPU.

Each of the ten configurations of the paper's comparisons (BASE ± Sup,
BASE_DSN, BASE_DASE, BASE_USE, MDViT_DSN, MDViT with the MLP, DeepLabV3 and
Transformer debranches, MDViT without the Sup gate), built by the registry
on both sides at tests/test_torch_trainer.py's tiny widths (DASE at 16
channels, so that its SE layers have a hidden unit), img 32, with
seeded variables carried into the port by ``from_jax_variables``. fp32 on
both sides, JAX at ``highest`` precision, mixed domains in one batch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.models.adapters import ResidualAdapter as JaxResidualAdapter
from mdvit_tpu.models.registry import get_model
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.models.adapters import ResidualAdapter
from torch_family import ROWS, is_mkd, onehot, port_model, random_variables, widths

torch.set_num_threads(2)

IMG = 32
DOMAINS = [2, 0, 3, 1, 1, 2, 0, 3]  # mixed domains in one batch
# tests/test_torch_mdvit.py's REL_TOL: the forwards sum in another order;
# relative to the output's scale
REL_TOL = 1e-4
DEBRANCH_ROWS = ["MDViT_DSN", "MDViT_MLP", "MDViT_DeepLabV3", "MDViT_Transformer"]


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs():
    x = np.random.RandomState(1).standard_normal((len(DOMAINS), IMG, IMG, 3))
    return x.astype(np.float32), onehot(DOMAINS)


@functools.lru_cache(maxsize=None)
def _row(row: str):
    """The JAX registry model of ``row``, its variables, its outputs in every
    aux mode the model has, and the port's model."""
    name, adapt, decoder = ROWS[row]
    kw = dict(widths(row), decoder_name=decoder) if decoder else widths(row)
    model = get_model(name, img_size=IMG, num_domains=4, adapt_method=adapt, **kw)
    x, oh = _inputs()
    variables = random_variables(model, jnp.asarray(x[:4]), jnp.asarray(oh[:4]))

    def outputs(v, x, oh):
        if not is_mkd(row):
            return {"none": model.apply(v, x, oh, train=False),
                    "no_seg": model.apply(v, x, oh, train=False, out_seg=False)}
        out = {mode: model.apply(v, x, oh, train=False, out_feat=True, aux_mode=mode)
               for mode in ("none", "select", "features")}
        feats = out["features"].pop("aux_features")
        deb = model.debranch_module()
        out["debranch"] = [deb.apply(jax.tree_util.tree_map(lambda a: a[d], {
            "params": v["params"]["debranch"], "batch_stats": v["batch_stats"]["debranch"]}),
            feats, None, False) for d in range(4)]
        return out

    want = jax.jit(outputs)(variables, x, oh)
    return model, variables, want, port_model(row, variables, IMG)


@pytest.mark.parametrize("row", list(ROWS))
def test_forward_matches_jax(row):
    """Serving forward (``aux_mode="none"``): logits and pooled features."""
    _, variables, want, model = _row(row)
    x, oh = _inputs()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(oh), aux_mode="none",
                    out_feat=True)
    if is_mkd(row):
        (logits, aux), (want_logits, want_aux) = got["seg"], want["none"]["seg"]
        assert aux is None and want_aux is None
    else:
        logits, want_logits = got["seg"], want["none"]["seg"]
    assert logits.shape == (len(DOMAINS), IMG, IMG, 1) and torch.isfinite(logits).all()
    assert _rel_err(logits, want_logits) < REL_TOL
    assert _rel_err(got["feat"], want["none"]["feat"]) < REL_TOL
    # the registry builds the same tree on both sides
    assert set(model.state_dict()) == set(from_jax_variables(variables))


@pytest.mark.parametrize("row", DEBRANCH_ROWS)
def test_aux_modes_match_jax(row):
    """Eval-mode aux logits: ``select`` over a mixed batch, and ``features``
    with ``debranch_module(d)`` applied to the whole batch for each d."""
    _, _, want, model = _row(row)
    x, oh = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        sel = model(x, oh, aux_mode="select")["seg"][1]
        out = model(x, oh, aux_mode="features")
        per_domain = [model.debranch_module(d)(out["aux_features"], False)
                      for d in range(4)]
    assert out["seg"][1] is None
    assert _rel_err(sel, want["select"]["seg"][1]) < REL_TOL
    for d in range(4):
        assert _rel_err(per_domain[d], want["debranch"][d]) < REL_TOL, d
    # select picks each sample's own debranch
    picked = torch.stack([per_domain[d][i] for i, d in enumerate(DOMAINS)])
    assert _rel_err(picked, sel) < REL_TOL


def test_base_features_only():
    """BASE with ``out_seg=False``: no logits, the pooled stage-4 features."""
    _, _, want, model = _row("BASE_Sup")
    x, oh = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        got = model(x, oh, out_seg=False)
    assert got["seg"] is None and want["no_seg"]["seg"] is None
    assert _rel_err(got["feat"], want["no_seg"]["feat"]) < REL_TOL


@pytest.mark.parametrize("mode", ["series", "parallel"])
def test_residual_adapter_matches_jax(mode):
    """``ResidualAdapter`` in eval and train mode (per-domain BN moments and
    running stats), its flax leaves mapped by hand: it is in no model."""
    rs = np.random.RandomState(3)
    x = rs.standard_normal((6, 5, 5, 12)).astype(np.float32)
    oh = onehot([0, 2, 2, 1, 0, 0])
    jmod = JaxResidualAdapter(channel=12, num_domains=4, mode=mode)
    v = random_variables(jmod, jnp.asarray(x), jnp.asarray(oh), seed=4)
    port = ResidualAdapter(12, 12, num_domains=4, mode=mode)
    sd = {"weight": torch.from_numpy(np.asarray(v["params"]["kernel"]))}
    for d in range(4):
        for leaf, tree, key in (("weight", "params", "scale"), ("bias", "params", "bias"),
                                ("running_mean", "batch_stats", "mean"),
                                ("running_var", "batch_stats", "var")):
            sd[f"bns.{d}.{leaf}"] = torch.from_numpy(np.asarray(v[tree]["bn"][key][d]))
    port.load_state_dict(sd)
    want_eval = jmod.apply(v, x, oh, train=False)
    want_train, upd = jmod.apply(v, x, oh, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = port(torch.from_numpy(x), torch.from_numpy(oh), train=False)
        got_train = port(torch.from_numpy(x), torch.from_numpy(oh), train=True)
    assert _rel_err(got_eval, want_eval) < REL_TOL
    assert _rel_err(got_train, want_train) < REL_TOL
    for d in range(4):  # domain 3 is absent: its stats stay as they were
        for leaf, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(port.bns[d], leaf).numpy(),
                                       np.asarray(upd["batch_stats"]["bn"][key][d]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{d} {leaf}")
    np.testing.assert_array_equal(port.bns[3].running_mean.numpy(),
                                  np.asarray(v["batch_stats"]["bn"]["mean"][3]))


def test_unmapped_keys_raise():
    """``from_jax_variables`` raises on a key it does not know: a module
    of the trunk with no rule (adapter and DSN trees) and a leaf with no
    rule inside a debranch."""
    for row, path, leaf in (("BASE_USE", ("core", "extra_adapter"), "kernel"),
                            ("MDViT_DeepLabV3", ("debranch", "aspp", "b0_conv"), "weights"),
                            ("MDViT_DSN", ("core", "bridge_gate"), "kernel")):
        _, variables, _, _ = _row(row)
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        node = params
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = {**node.get(path[-1], {}), leaf: np.zeros((2, 2), np.float32)}
        with pytest.raises(KeyError):
            from_jax_variables({"params": params})
