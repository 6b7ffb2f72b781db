"""The port's llama4 training (``transformer.forward``'s router aux loss,
``loss_fn``'s total, the backward through the capacity dispatch and the
chunk split) against the reference's ``jax.value_and_grad`` on the CPU.

Reduced scout (four MoE layers) and maverick (MoE on layers 1 and 3) in
float32, on the reference's weights (``params_from_jax``) and tokens from
a numpy seed. B = 2, T = 20: a chunked layer (``attn_chunk`` 8) attends
within two whole chunks and a tail of 4, so its attention is two calls
of ``kernels.autograd.flash_attention``. Each config runs at its own
capacity factor and at 0.5 (cap = 8 of 40 tokens over four experts, which
must drop tokens: asserted).

Tolerances, of the largest magnitude of the reference's value: rtol 1e-4
and atol 1e-5 (float32 sums in another order, the attention's online
softmax against the reference's blocked scan). The routing itself must be
the same: a flipped argmax would move a gradient by far more.

The reference gives every layer expert leaves and the port only MoE
layers (``transformer.py``): gradients and AdamW state are compared over
the port's leaves. The reference's unused leaves get a zero gradient and
AdamW's weight decay, which never reaches the loss.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama4_maverick_400b_a17b as r_maverick
from repro.configs import llama4_scout_17b_a16e as r_scout
from repro.models import transformer as RT
from repro.train import optimizer as ROpt
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TOpt
from repro_torch.train import steps as TSteps

torch.set_num_threads(1)

ARCHS = {"llama4-scout-17b-a16e": r_scout,
         "llama4-maverick-400b-a17b": r_maverick}
RTOL, ATOL = 1e-4, 1e-5          # atol of the largest magnitude
B, T = 2, 20
OPT = dict(warmup_steps=2, total_steps=10)
STEPS_LR_BOUND = 0.05            # |dp| over the summed lr (test_torch_train)


def _configs(arch, factor=None):
    rcfg = dataclasses.replace(ARCHS[arch].REDUCED, dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get(arch).make_reduced(),
                               dtype=torch.float32)
    if factor is not None:
        rcfg = dataclasses.replace(rcfg, capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=factor)
    return rcfg, tcfg


@functools.lru_cache(maxsize=None)
def _ref_grad(arch, factor=None):
    """The reference's jitted ``value_and_grad`` of its ``loss_fn``, one
    compile a config, shared by the gradient and the step tests."""
    rcfg = _configs(arch, factor)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rcfg, p, b), has_aux=True))


def _tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        RT.init_params(rcfg, jax.random.PRNGKey(seed))[0])


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, what):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max(), err_msg=what)


class _Routes:
    """Keeps every ``transformer.route`` call's Routing while installed."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = TT.route

        def rec(*a, **kw):
            r = real(*a, **kw)
            self.calls.append(r)
            return r
        monkeypatch.setattr(TT, "route", rec)

    def dropped(self):
        return [int((~r.keep).sum()) for r in self.calls]


@pytest.fixture(scope="module", params=[
    (a, f) for a in ARCHS for f in (None, 0.5)],
    ids=lambda p: f"{p[0].split('-')[1]}-cap{p[1] or 'cfg'}")
def grads(request):
    """Both packages' loss, metrics and gradients of one batch; the port's
    routings (forward, then the remat recompute) and attention calls."""
    arch, factor = request.param
    rcfg, tcfg = _configs(arch, factor)
    tree = _tree(rcfg)
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab, (B, T + 1)).astype(np.int32)
    (rl, rm), rg = _ref_grad(arch, factor)(tree, {"tokens": toks})
    params = TT.params_from_jax(tcfg, tree, device="cpu").requires_grad_(True)
    mp = pytest.MonkeyPatch()
    calls = []
    real_fa = ops.flash_attention

    def spy(q, k, v, *, causal, **knobs):
        calls.append(tuple(q.shape))
        return real_fa(q, k, v, causal=causal, **knobs)
    try:
        routes = _Routes(mp)
        mp.setattr(ops, "flash_attention", spy)
        tl, tm = TT.loss_fn(tcfg, params, {"tokens": toks})
        n_fwd = len(calls)
        tl.backward()
    finally:
        mp.undo()
    return dict(cfg=tcfg, ref_loss=float(rl), ref_metrics=rm,
                ref_grads=TT._named_from_tree(tcfg, jax.tree.map(
                    np.asarray, rg)),
                ref_all=jax.tree.map(np.asarray, rg),
                loss=tl, metrics=tm, routes=routes, attn=calls, n_fwd=n_fwd,
                grads={n: p.grad for n, p in params.named_parameters()})


def test_loss_and_router_aux_match_reference(grads):
    cfg = grads["cfg"]
    for k in ("ce", "router_aux"):
        assert grads["metrics"][k].dtype == torch.float32
        _close(grads["metrics"][k], grads["ref_metrics"][k], k)
    _close(grads["loss"], grads["ref_loss"], "total")
    m = {k: float(v.detach()) for k, v in grads["metrics"].items()}
    total = m["ce"] + cfg.router_aux_weight * m["router_aux"]
    assert float(grads["loss"].detach()) == pytest.approx(total, rel=1e-6)
    assert m["router_aux"] > 0


def test_every_gradient_leaf_matches_reference(grads):
    assert set(grads["grads"]) == set(grads["ref_grads"])
    for name, g in grads["grads"].items():
        assert g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), name
        _close(g, grads["ref_grads"][name], name)
    # the reference's expert leaves on dense layers (maverick's 0 and 2)
    # get no gradient: leaving them out of the port loses nothing
    cfg = grads["cfg"]
    for i in range(cfg.n_layers):
        if not cfg._is_moe(i):
            for k in ("router", "e_gate", "e_up", "e_down"):
                assert not grads["ref_all"]["layers"][k][i].any(), (i, k)


def test_capacity_drops_and_recompute_routes_alike(grads):
    """Each MoE layer routes twice (forward, then the remat recompute as
    the backward reaches it, last layer first), the same way; the
    capacity-0.5 cases drop tokens (cap 8 of 40 over 4 experts)."""
    cfg, calls = grads["cfg"], grads["routes"].calls
    n_moe = sum(cfg._is_moe(i) for i in range(cfg.n_layers))
    assert len(calls) == 2 * n_moe
    for a, b in zip(calls[:n_moe], calls[n_moe:][::-1]):
        assert torch.equal(a.eidx, b.eidx) and torch.equal(a.keep, b.keep)
    dropped = grads["routes"].dropped()[:n_moe]
    if cfg.capacity_factor == 0.5:
        assert calls[0].cap == 8 and min(dropped) > 0, dropped


def test_chunked_layers_split_into_two_attention_calls(grads):
    """T = 20 over chunks of 8: a chunked layer's attention is the two
    whole chunks as one batch and the tail of 4; a global layer is one
    call over the 20 positions; the recompute repeats each layer's calls,
    last layer first."""
    cfg = grads["cfg"]
    H, Dh = cfg.n_heads, cfg.hd
    per_layer = [[(B, H, T, Dh)] if TT._layer_flags(cfg, i)[0]
                 else [(B * 2, H, 8, Dh), (B, H, 4, Dh)]
                 for i in range(cfg.n_layers)]
    assert grads["attn"][:grads["n_fwd"]] == sum(per_layer, [])
    assert grads["attn"][grads["n_fwd"]:] == sum(per_layer[::-1], [])


def test_moe_backward_gives_dropped_tokens_no_routed_gradient():
    """The routed experts' output of a dropped token is 0 and so is its
    gradient from them, exactly: the scatter's extra row is cut off, the
    gather's output row is 0, so the gate's gradient is 0 too. Kept tokens
    get a gradient."""
    _, cfg = _configs("llama4-scout-17b-a16e", 0.5)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params.requires_grad_(True)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(40, cfg.d_model)).astype(
        np.float32)).requires_grad_(True)
    lw = params.layers[0]
    y, _ = TT._moe_ffn(cfg, lw, x)
    y.backward(torch.from_numpy(rng.normal(size=y.shape).astype(
        np.float32)))
    r = TT.route(cfg, lw.router, x.detach())
    kept = torch.zeros(40, dtype=torch.bool)
    kept[r.order] = r.keep
    assert 0 < int(kept.sum()) < 40
    assert bool((y[~kept] == 0).all())
    assert bool((x.grad[~kept] == 0).all())
    assert bool((x.grad[kept].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_two_train_steps_match_reference(arch):
    """Two AdamW steps through ``make_train_step`` (accum 1) from the same
    weights and batches: metrics within the tolerance, parameters within
    0.05 of the summed lr (AdamW's first steps are sign-like, as in
    ``test_torch_train.py``), the moments m and v within the tolerance of
    their largest. The reference's step at accum 1 is its
    ``value_and_grad`` then ``apply_updates`` (``repro.train.steps``),
    run here as two jitted calls so that the gradient's compile is the
    gradient test's."""
    rcfg, tcfg = _configs(arch)
    tree = _tree(rcfg, seed=2)
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, rcfg.vocab, (B, T + 1)).astype(
        np.int32)} for _ in range(2)]
    update = jax.jit(functools.partial(ROpt.apply_updates,
                                       ROpt.OptConfig(**OPT)))
    rp, rs, rms = tree, ROpt.init_state(tree), []
    for b in batches:
        (loss, m), g = _ref_grad(arch, None)(rp, b)
        rp, rs, om = update(rp, g, rs)
        rms.append({k: float(v) for k, v in {**m, **om,
                                              "loss": loss}.items()})
    params = TT.params_from_jax(tcfg, tree, device="cpu").requires_grad_(True)
    state = TOpt.init_state(params)
    tstep = TSteps.make_train_step(lambda p, b: TT.loss_fn(tcfg, p, b),
                                   TOpt.OptConfig(**OPT))
    tms = []
    for b in batches:
        params, state, m = tstep(params, state, b)
        tms.append({k: float(v) for k, v in m.items()})
    for got, want in zip(tms, rms):
        assert set(got) == set(want) == {"loss", "ce", "router_aux", "lr",
                                         "grad_norm"}
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        for k in ("loss", "ce", "router_aux", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=RTOL), k
    assert int(state.step) == 2
    lr_sum = sum(m["lr"] for m in tms)
    named = lambda t: TT._named_from_tree(tcfg, jax.tree.map(np.asarray, t))
    for n, w in named(rp).items():
        err = float(np.abs(_np(dict(params.named_parameters())[n]) - w).max())
        assert err <= STEPS_LR_BOUND * lr_sum, (n, err / lr_sum)
    for got, want in ((state.m, named(rs.m)), (state.v, named(rs.v))):
        assert set(got) == set(want)
        for n, w in want.items():
            _close(got[n], w, n)
