"""The port's GCN (``repro_torch.models.gnn``, ``configs.gcn_cora``,
``data.graph_sampler``, ``GNN_SHAPES``) against the reference's on the
CPU.

The graph generators and the fanout sampler are numpy in both packages:
``random_graph``, ``batched_molecules`` and ``NeighborSampler.sample`` (two
draws in a row, the sampler's generator advancing) must be equal bit for
bit. gcn-cora's REDUCED config (2 layers, d_feat 32, d_hidden 16, 5
classes) runs in both packages on the reference's weights
(``params_from_jax``) under the sym and row norms, through the three
losses: ``loss_fn`` on a whole graph with a label mask, ``graph_loss_fn``
on a packed batch of small graphs and ``sampled_loss_fn`` on a sampled
subgraph. Loss, metrics and every gradient (``jax.value_and_grad``)
agree within rtol 1e-4 and atol 1e-5 of the largest magnitude (float32
sums in another order: ``index_add`` against ``segment_sum``). Two AdamW
steps through ``make_train_step``: loss and grad norm within that
tolerance, parameters within 0.05 of the summed lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as r_gcn
from repro.data import graph_sampler as RG
from repro.models import gnn as RN
from repro.train import optimizer as ROpt
from repro.train import steps as RSteps
from repro_torch import configs
from repro_torch.data import graph_sampler as TG
from repro_torch.models import gnn as TN
from repro_torch.train import optimizer as TOpt
from repro_torch.train import steps as TSteps

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5          # atol of the largest magnitude
# reference options that its GCN never reads and the port leaves out
REF_ONLY = ("aggregator", "dropout")
OPT = dict(warmup_steps=2, total_steps=10)
STEPS_LR_BOUND = 0.05
LOSSES = {"full": ("loss_fn", {"ce", "acc"}),
          "molecule": ("graph_loss_fn", {"ce"}),
          "sampled": ("sampled_loss_fn", {"ce"})}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max(), err_msg=what)


def _cfgs(norm):
    return (dataclasses.replace(r_gcn.REDUCED, norm=norm),
            dataclasses.replace(configs.get("gcn-cora").REDUCED, norm=norm))


def _tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        RN.init_params(rcfg, jax.random.PRNGKey(seed))[0])


def _named(tree):
    return {f"layers.{i}.{k}": np.asarray(v)
            for i, lw in enumerate(tree["layers"]) for k, v in lw.items()}


def _batch(kind, cfg, seed=0):
    """A batch of each loss's layout at REDUCED's widths (numpy)."""
    if kind == "molecule":
        b = RG.batched_molecules(6, 9, 14, cfg.d_feat, cfg.n_classes, seed)
        b["labels"] = np.random.default_rng(seed).integers(
            0, cfg.n_classes, 6).astype(np.int32)       # a label a graph
        return b
    g = RG.random_graph(300, 1500, cfg.d_feat, cfg.n_classes, seed=seed)
    if kind == "sampled":
        seeds = np.random.default_rng(seed).choice(300, 16, replace=False)
        return RG.NeighborSampler(g, (4, 3), seed=seed).sample(seeds)
    mask = (np.random.default_rng(seed).random(g.n) < 0.3).astype(np.float32)
    return {"feats": g.feats, "edges": g.edges, "labels": g.labels,
            "label_mask": mask}


@pytest.fixture(scope="module", params=[(k, n) for k in LOSSES
                                        for n in ("sym", "row")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def grads(request):
    kind, norm = request.param
    rcfg, tcfg = _cfgs(norm)
    tree = _tree(rcfg)
    batch = _batch(kind, rcfg)
    fn = LOSSES[kind][0]
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: getattr(RN, fn)(rcfg, p, b), has_aux=True))(tree, batch)
    params = TN.params_from_jax(tcfg, tree, device="cpu").requires_grad_(True)
    tl, tm = getattr(TN, fn)(tcfg, params, batch)
    tl.backward()
    return dict(kind=kind, loss=tl, metrics=tm, ref_loss=rl, ref_metrics=rm,
                ref_grads=_named(jax.tree.map(np.asarray, rg)),
                grads={n: p.grad for n, p in params.named_parameters()})


def test_losses_match_reference(grads):
    keys = LOSSES[grads["kind"]][1]
    assert set(grads["metrics"]) == set(grads["ref_metrics"]) == keys
    _close(grads["loss"], grads["ref_loss"], "loss")
    for k in keys:
        _close(grads["metrics"][k], grads["ref_metrics"][k], k)


def test_every_gradient_leaf_matches_reference(grads):
    assert set(grads["grads"]) == set(grads["ref_grads"])
    for name, g in grads["grads"].items():
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), name
        _close(g, grads["ref_grads"][name], name)


@pytest.mark.parametrize("norm", ["sym", "row"])
def test_gcn_conv_and_forward_match_reference(norm):
    """One propagation with the degrees counted inside (no self-loops, so
    some nodes have in-degree 0: max(deg, 1)), and the forward's logits."""
    rcfg, tcfg = _cfgs(norm)
    b = _batch("full", rcfg, seed=4)
    x = b["feats"][:, :7]
    want = RN.gcn_conv(jnp.asarray(x), jnp.asarray(b["edges"]), 300, norm)
    got = TN.gcn_conv(torch.from_numpy(x), torch.from_numpy(b["edges"]), 300,
                      norm)
    _close(got, want)
    tree = _tree(rcfg, seed=1)
    _close(TN.forward(tcfg, TN.params_from_jax(tcfg, tree, "cpu"),
                      torch.from_numpy(b["feats"]),
                      torch.from_numpy(b["edges"])),
           RN.forward(rcfg, tree, jnp.asarray(b["feats"]),
                      jnp.asarray(b["edges"])))


@pytest.mark.parametrize("cluster", [True, False])
def test_random_graph_equals_reference_bitwise(cluster):
    want = RG.random_graph(500, 2000, 12, 6, seed=3, cluster=cluster)
    got = TG.random_graph(500, 2000, 12, 6, seed=3, cluster=cluster)
    for f in ("feats", "edges", "labels"):
        w, g = getattr(want, f), getattr(got, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert got.n_classes == want.n_classes and got.n == want.n == 500


def test_batched_molecules_equal_reference_bitwise():
    want = RG.batched_molecules(128, 30, 64, 32, 10, seed=5)
    got = TG.batched_molecules(128, 30, 64, 32, 10, seed=5)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_neighbor_sampler_equals_reference_bitwise():
    """Two draws from one sampler (its generator advances between them);
    node 0 has no in-edge, so the first hop skips it."""
    rg = RG.random_graph(400, 3000, 8, 4, seed=6)
    rg.edges = rg.edges[rg.edges[:, 1] != 0]
    tg = TG.Graph(rg.feats, rg.edges, rg.labels, rg.n_classes)
    rs, ts = RG.NeighborSampler(rg, (5, 3), 7), TG.NeighborSampler(tg, (5, 3),
                                                                  7)
    assert np.array_equal(ts.indptr, rs.indptr)
    for seeds in (np.array([0, 5, 9, 17]), np.arange(30, 62)):
        want, got = rs.sample(seeds), ts.sample(seeds)
        assert got.keys() == want.keys()
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_configs_copy_the_reference():
    from repro.configs import shapes as RShapes
    for shape in RShapes.GNN_SHAPES:
        r, t = r_gcn.make_config(shape), configs.get("gcn-cora").make_config(
            shape)
        for f in dataclasses.fields(r):
            if f.name not in ("dtype",) + REF_ONLY:
                assert getattr(t, f.name) == getattr(r, f.name), (shape, f)
        assert (r.aggregator, r.dropout) == ("mean", 0.0)
        assert t.param_count() == r.param_count()
    assert configs.get("gcn-cora").CONFIG == configs.get(
        "gcn-cora").make_config("full_graph_sm")
    red = configs.get("gcn-cora").REDUCED
    for f in dataclasses.fields(r_gcn.REDUCED):
        if f.name not in ("dtype",) + REF_ONLY:
            assert getattr(red, f.name) == getattr(r_gcn.REDUCED, f.name)
    params = TN.init_params(red, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in params.parameters()) == red.param_count()
    assert ({n: tuple(p.shape) for n, p in params.named_parameters()}
            == {n: a.shape for n, a in _named(_tree(r_gcn.REDUCED)).items()})


@pytest.mark.parametrize("kind", list(LOSSES))
def test_two_train_steps_match_reference(kind):
    rcfg, tcfg = _cfgs("sym")
    tree = _tree(rcfg, seed=2)
    batches = [_batch(kind, rcfg, seed=s) for s in (1, 2)]
    fn = LOSSES[kind][0]
    rstep = jax.jit(RSteps.make_train_step(
        lambda p, b: getattr(RN, fn)(rcfg, p, b), ROpt.OptConfig(**OPT)))
    rp, rs, rms = tree, ROpt.init_state(tree), []
    for b in batches:
        rp, rs, m = rstep(rp, rs, b)
        rms.append({k: float(v) for k, v in m.items()})
    params = TN.params_from_jax(tcfg, tree, device="cpu").requires_grad_(True)
    state = TOpt.init_state(params)
    tstep = TSteps.make_train_step(
        lambda p, b: getattr(TN, fn)(tcfg, p, b), TOpt.OptConfig(**OPT))
    tms = []
    for b in batches:
        params, state, m = tstep(params, state, b)
        tms.append({k: float(v) for k, v in m.items()})
    for got, want in zip(tms, rms):
        assert set(got) == set(want)
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=RTOL), k
    lr_sum = sum(m["lr"] for m in tms)
    for n, w in _named(jax.tree.map(np.asarray, rp)).items():
        err = float(np.abs(_np(dict(params.named_parameters())[n]) - w).max())
        assert err <= STEPS_LR_BOUND * lr_sum, (n, err / lr_sum)
