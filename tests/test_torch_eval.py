"""The port's eval path against the JAX package's, on the CPU: MDViT's
``select`` and ``features`` aux modes with ``debranch_module``, the masked
eval step on a padded tail (``from_store`` both ways), ``counts_to_metrics``
and the medpy-parity metrics.

A narrow MDViT (dims 16/32/40/64, one block per stage, Sup gate, MLPFM
debranches, 4 domains, img 32): JAX init, every parameter and BN stat
perturbed from a seeded numpy RandomState, carried into the port by
``from_jax_variables``; fp32, JAX at ``highest`` precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdvit_tpu.data.loader import eval_batches as jax_eval_batches
from mdvit_tpu.models.mdvit import MDViT as JaxMDViT
from mdvit_tpu.train import metrics as jm
from mdvit_tpu.train.steps import counts_to_metrics as jax_counts_to_metrics
from mdvit_tpu.train.steps import make_eval_step as jax_make_eval_step
from mdvit_tpu_torch.convert import from_jax_variables
from mdvit_tpu_torch.data.datasets import synthetic_domain_arrays
from mdvit_tpu_torch.data.loader import EvalSplitStore, eval_batches, eval_index_batches
from mdvit_tpu_torch.models.registry import build_mdvit
from mdvit_tpu_torch.train import metrics as tm
from mdvit_tpu_torch.train.steps import counts_to_metrics, make_eval_step

torch.set_num_threads(2)

IMG, D = 32, 4
NARROW = dict(num_layers=(1, 1, 1, 1), embed_dims=(16, 32, 40, 64))
# logits and losses: the forwards sum in another order (test_torch_mdvit.py)
REL_TOL = 1e-4


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def models():
    model = JaxMDViT(img_size=IMG, adapt="Sup", num_domains=D, **NARROW)
    x0 = jnp.zeros((D, IMG, IMG, 3))
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x0, jnp.eye(D), train=False,
        aux_mode="grouped"))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        noise = rs.standard_normal(leaf.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return leaf * np.exp(0.2 * noise)
        return leaf + 0.02 * noise

    variables = jax.tree_util.tree_map_with_path(perturb, dict(variables))
    port = build_mdvit(img_size=IMG, num_domains=D, device="cpu", **NARROW)
    port.load_state_dict(from_jax_variables(variables))
    return model, variables, port


def _images(n, seed=1):
    rs = np.random.RandomState(seed)
    return rs.uniform(0, 255, (n, IMG, IMG, 3)).astype(np.float32)


def _normalize(x):
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    return (np.clip(x, 0, 255) / 255.0 - mean) / std


def test_aux_select_matches_jax(models):
    model, variables, port = models
    x = _normalize(_images(4))
    oh = np.eye(D, dtype=np.float32)[[2, 0, 3, 1]]
    want = jax.jit(lambda v, x, oh: model.apply(v, x, oh, train=False,
                                                aux_mode="select"))(variables, x, oh)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(oh), aux_mode="select")
    for g, w in zip(got["seg"], want["seg"]):
        assert g.shape == w.shape and _rel_err(g.numpy(), w) < REL_TOL


@pytest.mark.parametrize("domain", [0, 3])
def test_aux_features_and_debranch_module_match_jax(models, domain):
    model, variables, port = models
    x = _normalize(_images(3, seed=domain))
    oh = np.zeros((3, D), np.float32)
    oh[:, domain] = 1.0
    want = jax.jit(lambda v, x, oh: model.apply(v, x, oh, train=False,
                                                aux_mode="features"))(variables, x, oh)
    aux_vars = {c: jax.tree_util.tree_map(lambda a: a[domain], variables[c]["debranch"])
                for c in ("params", "batch_stats")}
    want_aux = model.debranch_module().apply(aux_vars, want["aux_features"], None, False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(oh), aux_mode="features")
        got_aux = port.debranch_module(domain)(got["aux_features"], False)
    assert got["seg"][1] is None and want["seg"][1] is None
    assert len(got["aux_features"]) == len(want["aux_features"]) == 5
    for g, w in zip(got["aux_features"], want["aux_features"]):
        assert _rel_err(g.numpy(), w) < REL_TOL
    assert _rel_err(got["seg"][0].numpy(), want["seg"][0]) < REL_TOL
    assert _rel_err(got_aux.numpy(), want_aux) < REL_TOL


@pytest.mark.parametrize("from_store", [True, False], ids=["store", "host"])
def test_eval_step_matches_jax_on_a_padded_tail(models, from_store):
    """Batches of 5 over a domain of 7: one full batch and a tail of 2
    padded to 5 (with a real row from the store, with zeros from the host),
    routed to domain 1's debranch; the masked counts and loss agree."""
    model, variables, port = models
    d, bs = 1, 5
    test = synthetic_domain_arrays("PH2", IMG, 0, 7)["test"]
    other = synthetic_domain_arrays("isic2018", IMG, 0, 3)["test"]
    onehot = np.zeros((bs, D), np.float32)
    onehot[:, d] = 1.0
    aux_vars = {c: jax.tree_util.tree_map(lambda a: a[d], variables[c]["debranch"])
                for c in ("params", "batch_stats")}
    jstep = jax.jit(jax_make_eval_step(model, mkd=True, from_store=from_store))
    step = make_eval_step(port, mkd=True, from_store=from_store)
    if from_store:
        store = EvalSplitStore([other, test], "cpu")
        off, n = store.domain(1)
        simgs, smsks = store.images.numpy(), store.masks.numpy()
        batches = [((store.images, store.masks, torch.from_numpy(idx).long(), valid),
                    (simgs, smsks, idx, valid))
                   for idx, valid in eval_index_batches(off, n, bs)]
    else:
        batches = [((torch.from_numpy(i), torch.from_numpy(m), None, v), (i, m, None, v))
                   for (i, m, v) in eval_batches(test, bs)]
        for (_, (i, m, _, v)), (wi, wm, wv) in zip(batches, jax_eval_batches(test, bs)):
            np.testing.assert_array_equal(i, wi)
    assert [b[1][3] for b in batches] == [5, 2]
    for (imgs, msks, idx, valid), (jimgs, jmsks, jidx, _) in batches:
        want = jstep(variables["params"], variables["batch_stats"], jimgs, jmsks,
                     onehot, jnp.int32(valid), aux_vars=aux_vars, indices=jidx)
        got = step(imgs, msks, torch.from_numpy(onehot), valid, domain=d, indices=idx)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=REL_TOL)
        for head in ("primary", "aux"):
            for k in ("inter", "sum_pred", "sum_true"):
                np.testing.assert_allclose(float(got[head][k]), float(want[head][k]),
                                           rtol=REL_TOL, err_msg=f"{head}/{k}")
            assert counts_to_metrics(got[head]) == pytest.approx(
                jax_counts_to_metrics(want[head]), rel=REL_TOL)
        assert float(got["primary"]["sum_true"]) > 0


def test_eval_step_pads_are_ignored(models):
    """Whatever the padded rows hold, the counts and loss are those of the
    valid rows."""
    _, _, port = models
    step = make_eval_step(port, mkd=True)
    imgs = torch.from_numpy(_images(5, seed=4))
    msks = torch.from_numpy((np.random.RandomState(5).rand(5, IMG, IMG) > 0.5)
                            .astype(np.float32))
    oh = torch.zeros(5, D)
    oh[:, 2] = 1
    a = step(imgs, msks, oh, 3, domain=2)
    imgs2, msks2 = imgs.clone(), msks.clone()
    imgs2[3:], msks2[3:] = 255 - imgs2[3:], 1 - msks2[3:]
    b = step(imgs2, msks2, oh, 3, domain=2)
    for head in ("primary", "aux"):
        for k in a[head]:
            assert float(a[head][k]) == float(b[head][k])
    np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), rtol=1e-6)


def test_counts_to_metrics_empty_sets():
    for c in ({"inter": 0, "sum_pred": 0, "sum_true": 0},
              {"inter": 3, "sum_pred": 4, "sum_true": 5}):
        assert counts_to_metrics(c) == jax_counts_to_metrics(c)


def test_metrics_match_jax():
    rs = np.random.RandomState(6)
    probs = rs.rand(3, 8, 8, 1).astype(np.float32)
    target = (rs.rand(3, 8, 8, 1) > 0.6).astype(np.float32)
    empty = np.zeros_like(target)
    for p, t in ((probs, target), (np.zeros_like(probs), empty)):
        pred = (p > 0.5).astype(np.float32)
        for name in ("dice_coef", "jaccard", "dice_per_image"):
            got = getattr(tm, name)(torch.from_numpy(pred), torch.from_numpy(t)).numpy()
            np.testing.assert_allclose(got, np.asarray(getattr(jm, name)(pred, t)),
                                       rtol=1e-6, err_msg=name)
        got = tm.seg_metrics(torch.from_numpy(p), torch.from_numpy(t))
        want = jm.seg_metrics(p, t)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_eval_step_without_mkd_has_no_aux(models):
    """mkd=False: the primary head only (``aux_mode="none"``), the same
    counts and loss as the MKD step's primary head."""
    _, _, port = models
    imgs = torch.from_numpy(_images(3, seed=7))
    msks = torch.from_numpy((np.random.RandomState(8).rand(3, IMG, IMG) > 0.5)
                            .astype(np.float32))
    oh = torch.eye(D)[[1, 1, 1]]
    base = make_eval_step(port, mkd=False)(imgs, msks, oh, 3)
    full = make_eval_step(port, mkd=True)(imgs, msks, oh, 3, domain=1)
    assert "aux" not in base
    assert float(base["loss"]) == float(full["loss"])
    for k in base["primary"]:
        assert float(base["primary"][k]) == float(full["primary"][k])
