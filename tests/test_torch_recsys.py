"""The port's recsys models (``repro_torch.models.recsys``, the fm, deepfm,
wide-deep and din configs, ``layers.mlp_stack``/``mlp_apply``,
``data.pipelines.recsys_batch``, ``RECSYS_SHAPES``) against the
reference's on the CPU.

Each REDUCED config runs in both packages on the reference's weights
(``params_from_jax``) and the same ``recsys_batch`` arrays, which must be
equal bit for bit (numpy from the same seed). Forward, loss and every
gradient (the reference's ``jax.value_and_grad``) agree within rtol 1e-4
and atol 1e-5 of the largest magnitude (float32 sums in another order:
the field sums, ``index_add`` against ``segment_sum``, the MLP products).
Two AdamW steps through ``make_train_step``: the logloss and grad norm
within that tolerance, the parameters within 0.05 of the summed lr (the
sign-like first steps, as in ``test_torch_train.py``).

Retrieval: ``jax.lax.top_k`` breaks ties toward the lower index and
``torch.topk`` promises no order of equal scores, so scores are compared
allclose and ids only where a score is distinct from every other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as r_deepfm
from repro.configs import din as r_din
from repro.configs import fm as r_fm
from repro.configs import shapes as RShapes
from repro.configs import wide_deep as r_wide_deep
from repro.data import pipelines as RP
from repro.models import layers as RL
from repro.models import recsys as RR
from repro.train import optimizer as ROpt
from repro.train import steps as RSteps
from repro_torch import configs
from repro_torch.configs import shapes as TShapes
from repro_torch.data import pipelines as TP
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR
from repro_torch.train import optimizer as TOpt
from repro_torch.train import steps as TSteps

torch.set_num_threads(1)

ARCHS = {"fm": r_fm, "deepfm": r_deepfm, "wide-deep": r_wide_deep,
         "din": r_din}
RTOL, ATOL = 1e-4, 1e-5          # atol of the largest magnitude
# reference options that no config sets and the port leaves out
REF_ONLY = ("field_vocabs",)
B = 64
OPT = dict(warmup_steps=2, total_steps=10)
STEPS_LR_BOUND = 0.05


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max(), err_msg=what)


def _tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        RR.init_params(rcfg, jax.random.PRNGKey(seed))[0])


def _batch(cfg, step, masked=False):
    b = RP.recsys_batch(step, B, cfg.n_sparse, cfg.vocabs(), cfg.n_dense,
                        seed=3, kind=cfg.kind, seq_len=cfg.seq_len)
    if masked:                   # ragged histories, one wholly masked row
        mask = np.random.default_rng(step).random(b["hist_mask"].shape) < .6
        mask[0] = False
        b["hist_mask"] = mask
    return b


def _named(tree):
    """The reference tree's leaves under the port's parameter names."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = np.asarray(t)
    walk("", tree)
    return out


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS
                                        for m in (False, True)
                                        if not m or a == "din"],
                ids=lambda p: p[0] + ("-masked" if p[1] else ""))
def grads(request):
    arch, masked = request.param
    rcfg, tcfg = ARCHS[arch].REDUCED, configs.get(arch).make_reduced()
    tree = _tree(rcfg)
    batch = _batch(rcfg, 0, masked)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RR.loss_fn(rcfg, p, b), has_aux=True))(tree, batch)
    want_logits = jax.jit(lambda p, b: RR.forward(rcfg, p, b))(tree, batch)
    params = TR.params_from_jax(tcfg, tree, device="cpu")
    with torch.no_grad():
        logits = TR.forward(tcfg, params, batch)
    params.requires_grad_(True)
    tl, tm = TR.loss_fn(tcfg, params, batch)
    tl.backward()
    return dict(cfg=tcfg, logits=logits, ref_logits=want_logits, loss=tl,
                metrics=tm, ref_loss=rl, ref_metrics=rm,
                ref_grads=_named(jax.tree.map(np.asarray, rg)),
                grads={n: p.grad for n, p in params.named_parameters()})


def test_forward_matches_reference(grads):
    assert tuple(grads["logits"].shape) == (B,)
    assert grads["logits"].dtype == torch.float32
    _close(grads["logits"], grads["ref_logits"], "logits")


def test_loss_matches_reference(grads):
    assert set(grads["metrics"]) == set(grads["ref_metrics"]) == {"logloss"}
    _close(grads["loss"], grads["ref_loss"], "loss")
    assert grads["metrics"]["logloss"] is grads["loss"]


def test_every_gradient_leaf_matches_reference(grads):
    """Every leaf within the tolerance, except DIN's last attention bias:
    the softmax over the history ignores a shift of every score, so its
    gradient is 0 up to rounding in both packages (held below 1e-6 of the
    largest gradient)."""
    assert set(grads["grads"]) == set(grads["ref_grads"])
    top = max(float(np.abs(g).max()) for g in grads["ref_grads"].values())
    shift = f"attn_mlp.{len(grads['cfg'].attn_mlp_dims)}.b"
    for name, g in grads["grads"].items():
        assert bool(torch.isfinite(g).all()), name
        if name == shift:
            assert max(float(g.abs().max()), float(np.abs(
                grads["ref_grads"][name]).max())) <= 1e-6 * top
            continue
        assert bool((g != 0).any()), name
        _close(g, grads["ref_grads"][name], name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_and_param_count_copy_the_reference(arch):
    for which in ("CONFIG", "REDUCED"):
        rcfg = getattr(ARCHS[arch], which)
        spec = configs.get(arch)
        tcfg = (spec.make_config() if which == "CONFIG"
                else spec.make_reduced())
        for f in dataclasses.fields(rcfg):
            if f.name not in ("dtype",) + REF_ONLY:
                assert getattr(tcfg, f.name) == getattr(rcfg, f.name), f.name
        assert all(getattr(rcfg, f) in ((), None) for f in REF_ONLY)
        assert tcfg.dtype == torch.float32
        assert tcfg.vocabs() == rcfg.vocabs()
        assert tcfg.param_count() == rcfg.param_count()
    tcfg = configs.get(arch).make_reduced()
    params = TR.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    # the reference's count leaves out the scalar bias of fm, deepfm and
    # wide-deep; the port copies the count as it is
    assert sum(p.numel() for p in params.parameters()) == \
        tcfg.param_count() + hasattr(params, "bias")
    assert ({n: tuple(p.shape) for n, p in params.named_parameters()}
            == {n: a.shape for n, a in _named(
                _tree(ARCHS[arch].REDUCED)).items()})
    assert abs(float(params.table.std()) - 0.01) < 1e-3
    assert not any(p.requires_grad for p in params.parameters())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_recsys_batch_equals_reference_bitwise(arch):
    cfg = ARCHS[arch].REDUCED
    for step in (0, 5):
        want = RP.recsys_batch(step, 33, cfg.n_sparse, cfg.vocabs(),
                               cfg.n_dense, seed=2, kind=cfg.kind,
                               seq_len=cfg.seq_len)
        got = TP.recsys_batch(step, 33, cfg.n_sparse, cfg.vocabs(),
                              cfg.n_dense, seed=2, kind=cfg.kind,
                              seq_len=cfg.seq_len)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_shapes_copy_the_reference():
    assert TShapes.RECSYS_SHAPES == RShapes.RECSYS_SHAPES
    assert TShapes.GNN_SHAPES == RShapes.GNN_SHAPES
    assert TShapes.LM_SHAPES == RShapes.LM_SHAPES


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_embedding_bag_matches_reference(combine):
    """Bags of random sizes over 9 segments, two of them empty (0 rows:
    the mean divides by max(count, 1))."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    seg = np.sort(rng.choice([0, 1, 2, 4, 5, 6, 8], 40)).astype(np.int32)
    want = RR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(seg), 9, combine)
    got = TR.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(seg), 9, combine)
    _close(got, want)
    assert not got[3].any() and not got[7].any()
    offs = TR.field_offsets(configs.get("fm").make_reduced(), "cpu")
    np.testing.assert_array_equal(
        offs.numpy(), np.asarray(RR.field_offsets(r_fm.REDUCED)))


def test_mlp_stack_and_apply_match_reference():
    dims = [12, 7, 5, 1]
    tree = jax.tree.map(np.asarray, RL.mlp_stack(jax.random.PRNGKey(1),
                                                 dims)[0])
    tower = TL.copy_from_tree(TL.mlp_stack(dims, None), tree)
    x = np.random.default_rng(6).normal(size=(9, 12)).astype(np.float32)
    for final in (False, True):
        _close(TL.mlp_apply(tower, torch.from_numpy(x), final_act=final),
               RL.mlp_apply(tree, jnp.asarray(x), final_act=final))
    drawn = TL.mlp_stack([400, 300], torch.Generator().manual_seed(0))
    assert abs(float(drawn[0].w.detach().std()) * 20 - 1.0) < 0.02   # 1/sqrt(400)
    assert not drawn[0].b.detach().any()
    w = TL.dense(torch.Generator().manual_seed(0), 64, 32)
    assert tuple(w.shape) == (64, 32)
    assert abs(float(w.std()) * 8 - 1.0) < 0.1                   # 1/sqrt(64)


def test_retrieval_topk_matches_reference():
    """One user vector and three others against 4,000 candidates, half of
    them duplicated rows (tied scores)."""
    rng = np.random.default_rng(7)
    cand = rng.normal(size=(4000, 18)).astype(np.float32)
    cand[2000:] = cand[:2000]
    user = rng.normal(size=(4, 18)).astype(np.float32)
    rs, ri = RR.retrieval_topk(jnp.asarray(user), jnp.asarray(cand), k=100)
    ts, ti = TR.retrieval_topk(torch.from_numpy(user),
                               torch.from_numpy(cand), k=100)
    _close(TR.retrieval_scores(torch.from_numpy(user),
                               torch.from_numpy(cand)),
           RR.retrieval_scores(jnp.asarray(user), jnp.asarray(cand)))
    _close(ts, rs)
    ri, ti = np.asarray(ri), ti.numpy()
    full = np.asarray(RR.retrieval_scores(jnp.asarray(user),
                                          jnp.asarray(cand)))
    for b in range(4):
        vals, counts = np.unique(full[b], return_counts=True)
        distinct = np.isin(full[b][ri[b]], vals[counts == 1])
        assert distinct.sum() < 100                  # ties are present
        assert np.array_equal(ti[b][distinct], ri[b][distinct])
        # a tied pair is the same two rows, in either order
        assert set(ti[b][~distinct] % 2000) == set(ri[b][~distinct] % 2000)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_two_train_steps_match_reference(arch):
    rcfg, tcfg = ARCHS[arch].REDUCED, configs.get(arch).make_reduced()
    tree = _tree(rcfg, seed=1)
    batches = [_batch(rcfg, s) for s in (1, 2)]
    rstep = jax.jit(RSteps.make_train_step(
        lambda p, b: RR.loss_fn(rcfg, p, b), ROpt.OptConfig(**OPT)))
    rp, rs, rms = tree, ROpt.init_state(tree), []
    for b in batches:
        rp, rs, m = rstep(rp, rs, b)
        rms.append({k: float(v) for k, v in m.items()})
    params = TR.params_from_jax(tcfg, tree, device="cpu").requires_grad_(True)
    state = TOpt.init_state(params)
    tstep = TSteps.make_train_step(lambda p, b: TR.loss_fn(tcfg, p, b),
                                   TOpt.OptConfig(**OPT))
    tms = []
    for b in batches:
        params, state, m = tstep(params, state, b)
        tms.append({k: float(v) for k, v in m.items()})
    for got, want in zip(tms, rms):
        assert set(got) == set(want) == {"loss", "logloss", "lr",
                                         "grad_norm"}
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=RTOL), k
    lr_sum = sum(m["lr"] for m in tms)
    for n, w in _named(jax.tree.map(np.asarray, rp)).items():
        err = float(np.abs(_np(dict(params.named_parameters())[n]) - w).max())
        assert err <= STEPS_LR_BOUND * lr_sum, (n, err / lr_sum)


@pytest.mark.parametrize("arch", ["deepfm", "din"])
def test_bf16_table_matches_reference(arch):
    """``table_dtype=bfloat16`` (the perf harness's din variant): the
    table is stored in bf16, its rows promote to float32 where they meet
    the float32 towers, as JAX promotes them; logits and loss within 2^-6
    of the largest of the reference's on the same bf16 table (the bf16
    tolerance of ``test_torch_lm.py``; deepfm's FM term sums bf16 rows in
    bf16), the reference jitted with ``xla_allow_excess_precision`` off so
    that it rounds every bf16 op as torch does."""
    rcfg = dataclasses.replace(ARCHS[arch].REDUCED,
                               table_dtype=jax.numpy.bfloat16)
    tcfg = dataclasses.replace(configs.get(arch).make_reduced(),
                               table_dtype=torch.bfloat16)
    tree = _tree(rcfg)
    batch = _batch(rcfg, 0)
    opts = {"xla_allow_excess_precision": False}
    want = jax.jit(lambda p, b: RR.forward(rcfg, p, b)).lower(
        tree, batch).compile(compiler_options=opts)(tree, batch)
    rl, _ = jax.jit(lambda p, b: RR.loss_fn(rcfg, p, b)).lower(
        tree, batch).compile(compiler_options=opts)(tree, batch)
    # torch takes no ml_dtypes bfloat16 array: widen (exactly) to carry it
    wide = jax.tree.map(lambda a: a.astype(np.float32)
                        if a.dtype.name == "bfloat16" else a, tree)
    params = TR.params_from_jax(tcfg, wide, device="cpu")
    assert params.table.dtype == torch.bfloat16
    assert params.mlp[0].w.dtype == torch.float32
    with torch.no_grad():
        logits = TR.forward(tcfg, params, batch)
        tl, _ = TR.loss_fn(tcfg, params, batch)
    assert logits.dtype == torch.float32
    for got, ref_ in ((logits, want), (tl, rl)):
        ref_ = np.asarray(ref_, np.float32)
        assert np.abs(_np(got) - ref_).max() <= 2.0 ** -6 * np.abs(ref_).max()
