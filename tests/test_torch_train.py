"""The port's LM training (``repro_torch.train``, ``transformer.loss_fn``,
``kernels.autograd``, ``data.pipelines.lm_batch``) against the reference's
on the CPU.

The reduced qwen3, minicpm and gemma configs run in both packages on the
same weights (``params_from_jax``), the same optimizer state
(``opt_state_from_jax``) and the same tokens from numpy.

Tolerances:
- ``schedule_lr``, ``global_norm`` and ``apply_updates`` (params, m, v,
  lr, grad_norm): rtol 1e-6, atol 1e-7; float32 op for op, the sums over
  leaves in another order.
- ``loss_fn`` and every gradient leaf, of the largest magnitude of the
  reference's value: float32 2e-5 (``test_torch_lm.py``'s TOL; measured
  up to 6.5e-6, the attention's float32 sums in another order); bf16
  2^-6, two bf16 steps at the top of the range (measured up to 0.0153 on
  gemma's ``wv`` and 0.0150 on qwen3's ``embed``: besides the forward's
  roundings, torch's backward formulas round their bf16 intermediates in
  other places than JAX's). The reference runs under ``jit``; in bf16
  with XLA's ``xla_allow_excess_precision`` off, which rounds every bf16
  op to bf16 as an eager run does (``test_torch_lm.py`` says why that
  matters; its gradients measured within 0.0027 of the largest of the
  eager run's, at a tenth of its time).
- Parameters after steps, float32 only, in units of the summed ``lr``:
  AdamW's first steps move a parameter by about ``lr`` times the sign of
  its gradient wherever |g| >> eps, so a rounding of a gradient near zero
  could move it by up to 2 lr. The bound is 0.05 of the summed lr (no
  update of opposite sign; measured 0.0046). In bf16 only the loss and
  the gradients are compared.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_7b as r_gemma
from repro.configs import minicpm_2b as r_minicpm
from repro.configs import qwen3_1_7b as r_qwen
from repro.data import pipelines as RP
from repro.models import transformer as RT
from repro.train import optimizer as ROpt
from repro.train import steps as RSteps
from repro_torch import configs
from repro_torch.data import pipelines as TP
from repro_torch.kernels import autograd as KA
from repro_torch.kernels import ops, ref
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as TT
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.train import optimizer as TOpt
from repro_torch.train import steps as TSteps

torch.set_num_threads(1)

ARCHS = {"qwen3-1.7b": r_qwen, "minicpm-2b": r_minicpm,
         "gemma-7b": r_gemma}
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
B, T = 2, 24
OPT = dict(warmup_steps=2, total_steps=10)
STEPS_LR_BOUND = 0.05           # |dp| over the summed lr, float32 steps


def _configs(arch, dtype="float32"):
    rcfg = ARCHS[arch].REDUCED
    tcfg = configs.get(arch).make_reduced()
    if dtype == "float32":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return rcfg, tcfg


def _tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        RT.init_params(rcfg, jax.random.PRNGKey(seed))[0])


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close_leaf(got, want, tol, what):
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _tokens(vocab, seed=0, rows=B):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, T + 1)).astype(np.int32)


# -- the loss and its gradient ------------------------------------------------

@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def grads(request):
    """Both packages' loss and gradient of one batch."""
    arch, dtype = request.param
    rcfg, tcfg = _configs(arch, dtype)
    tree = _tree(rcfg)
    toks = _tokens(rcfg.vocab)

    def rloss(p, t):
        return RT.loss_fn(rcfg, p, {"tokens": t})
    (rl, rm), rg = jax.jit(jax.value_and_grad(rloss, has_aux=True)).lower(
        tree, toks).compile(compiler_options={
            "xla_allow_excess_precision": dtype == "float32"})(tree, toks)
    params = TT.params_from_jax(tcfg, tree, device="cpu").requires_grad_(True)
    tl, tm = TT.loss_fn(tcfg, params, {"tokens": toks})
    tl.backward()
    return dict(dtype=dtype, ref_loss=rl, ref_aux=rm,
                ref_grads=TT._named_from_tree(tcfg, jax.tree.map(np.asarray,
                                                                 rg)),
                loss=tl, aux=tm,
                grads={n: p.grad for n, p in params.named_parameters()})


def test_loss_matches_reference(grads):
    tol = TOL[grads["dtype"]]
    loss = float(grads["loss"].detach())
    assert abs(loss - float(grads["ref_loss"])) <= \
        tol * abs(float(grads["ref_loss"]))
    assert grads["loss"].dtype == torch.float32
    assert float(grads["aux"]["router_aux"]) == float(
        grads["ref_aux"]["router_aux"]) == 0.0
    assert float(grads["aux"]["ce"].detach()) == loss


def test_every_gradient_leaf_matches_reference(grads):
    assert set(grads["grads"]) == set(grads["ref_grads"])
    for name, g in grads["grads"].items():
        assert g.dtype == torch.float32, name
        _close_leaf(g, grads["ref_grads"][name], TOL[grads["dtype"]], name)


def test_every_parameter_gets_a_gradient(grads):
    """Attention's q/k/v projections, ln1 and the qk-norms get their
    gradient only through the attention's backward: none may be zero."""
    for name, g in grads["grads"].items():
        assert bool(torch.isfinite(g).all()), name
        assert bool((g != 0).any()), name


def test_loss_mask_matches_reference():
    rcfg, tcfg = _configs("qwen3-1.7b")
    tree = _tree(rcfg)
    toks = _tokens(rcfg.vocab, seed=4)
    mask = np.random.default_rng(5).random(toks.shape) < 0.6
    want, _ = jax.jit(lambda p, t, m: RT.loss_fn(
        rcfg, p, {"tokens": t, "loss_mask": m}))(tree, toks, mask)
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    got, _ = TT.loss_fn(tcfg, params, {"tokens": toks, "loss_mask": mask})
    assert abs(float(got) - float(want)) <= TOL["float32"] * abs(float(want))
    empty = softmax_cross_entropy(torch.zeros(1, 3, 5), torch.zeros(1, 3),
                                  torch.zeros(1, 3))
    assert float(empty) == 0.0                  # sum 0 over max(0, 1)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_equal_no_remat_bitwise(policy):
    """Checkpointing recomputes the same ops on the same inputs: the loss
    and every gradient equal the run without remat, bit for bit."""
    _, tcfg = _configs("qwen3-1.7b", "bfloat16")
    tree = _tree(ARCHS["qwen3-1.7b"].REDUCED)
    toks = torch.from_numpy(_tokens(tcfg.vocab, seed=2))
    out = {}
    for mode in ("none", policy):
        cfg = dataclasses.replace(tcfg, remat_policy=policy)
        params = TT.params_from_jax(cfg, tree, device="cpu")
        params.requires_grad_(True)
        logits, aux = TT.forward(cfg, params, toks[:, :-1],
                                 remat=mode != "none")
        assert float(aux) == 0.0
        loss = softmax_cross_entropy(logits[..., :cfg.vocab], toks[:, 1:])
        loss.backward()
        out[mode] = (loss.detach(), {n: p.grad for n, p in
                                     params.named_parameters()})
    assert torch.equal(out["none"][0], out[policy][0])
    for name, g in out["none"][1].items():
        assert torch.equal(g, out[policy][1][name]), name


def test_remat_policy_is_checked():
    _, tcfg = _configs("qwen3-1.7b")
    with pytest.raises(ValueError):
        TT.check_supported(dataclasses.replace(tcfg, remat_policy="offload"))


# -- attention ----------------------------------------------------------------

def test_flash_attention_function_gradient_is_the_plain_versions():
    """On the CPU the Function's forward is the plain version, and its
    backward differentiates the plain version recomputed: both equal
    autograd through ``ref.flash_attention``, bit for bit."""
    rng = np.random.default_rng(7)
    shapes = [(2, 4, 20, 16), (2, 2, 20, 16), (2, 2, 20, 16)]
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]
    dout = torch.from_numpy(rng.normal(size=shapes[0]).astype(np.float32))
    got, want = [], []
    for fn, sink in ((KA.flash_attention, got), (ref.flash_attention, want)):
        qkv = [t.clone().requires_grad_(True) for t in base]
        out = fn(*qkv, causal=True)
        out.backward(dout)
        sink.extend([out.detach()] + [t.grad for t in qkv])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _wrapper_calls():
    f = torch.float32
    rng = np.random.default_rng(8)

    def t(*shape, dtype=f):
        a = rng.normal(size=shape) if dtype == f else rng.integers(
            0, 4, shape)
        return torch.from_numpy(np.asarray(a)).to(dtype)
    return {
        "fused_expand": lambda g: ops.fused_expand(
            t(6, 10).requires_grad_(g), t(2, 3, dtype=torch.int32),
            t(2, 8), t(2), d=8),
        "gather_dist_tile": lambda g: ops.gather_dist_tile(
            t(8, 8).requires_grad_(g), t(2, dtype=torch.int32), t(2, 8),
            tile=4),
        "gather_dist": lambda g: ops.gather_dist(
            t(6, 8), t(2, 3, dtype=torch.int32), t(2, 8).requires_grad_(g)),
        "l2dist": lambda g: ops.l2dist(t(2, 8).requires_grad_(g), t(5, 8)),
        "flash_attention": lambda g: ops.flash_attention(
            t(1, 2, 4, 8), t(1, 1, 4, 8).requires_grad_(g), t(1, 1, 4, 8)),
    }


@pytest.mark.parametrize("name", ["fused_expand", "gather_dist_tile",
                                  "gather_dist", "l2dist",
                                  "flash_attention"])
def test_ops_raise_on_inputs_that_require_grad(name):
    """A kernel's output has no grad_fn, so each wrapper refuses an input
    that requires grad while grad mode is on, on the CPU as on the card
    (bitset_dist takes integer words, which cannot require grad)."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    with torch.no_grad():
        call(True)
    call(False)


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["const", "linear", "cosine", "wsd"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(schedule=schedule, warmup_steps=3, total_steps=20)
    rcfg, tcfg = ROpt.OptConfig(**kw), TOpt.OptConfig(**kw)
    for s in range(0, 27):               # across and past total_steps
        want = np.asarray(ROpt.schedule_lr(rcfg, jnp.int32(s)))
        got = TOpt.schedule_lr(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        TOpt.schedule_lr(TOpt.OptConfig(schedule="step"), torch.tensor(1))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(9)
    tree = {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(300,)).astype(np.float32)}}
    want = ROpt.global_norm(jax.tree.map(jnp.asarray, tree))
    got = TOpt.global_norm({"a": torch.from_numpy(tree["a"]),
                            "b.c": torch.from_numpy(tree["b"]["c"])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_apply_updates_matches_reference(clip):
    """One update from the same state at step 7 (m, v random, v > 0):
    parameters, moments, lr and grad_norm."""
    rcfg, tcfg = _configs("qwen3-1.7b")
    tree = _tree(rcfg, seed=1)
    rng = np.random.default_rng(10)

    def like(scale, positive=False):
        out = jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale)
                           .astype(np.float32), tree)
        return jax.tree.map(np.square, out) if positive else out
    grads = like(1.0)
    n = sum(a.size for a in jax.tree.leaves(grads))
    if clip == "inactive":               # global norm 0.5 < clip_norm 1
        grads = jax.tree.map(lambda a: a * np.float32(0.5 / math.sqrt(n)),
                             grads)
    rstate = ROpt.AdamWState(np.int32(7), like(0.01), like(0.01, True))
    ocfg = dict(warmup_steps=3, total_steps=20)
    rp, rs, rm = jax.jit(lambda *a: ROpt.apply_updates(
        ROpt.OptConfig(**ocfg), *a))(tree, grads, rstate)
    gnorm = float(rm["grad_norm"])
    assert (gnorm > 1.0) == (clip == "active")

    params = TT.params_from_jax(tcfg, tree, device="cpu")
    state = TT.opt_state_from_jax(tcfg, rstate, device="cpu")
    tgrads = {k: torch.from_numpy(v)
              for k, v in TT._named_from_tree(tcfg, grads).items()}
    params, state, m = TOpt.apply_updates(TOpt.OptConfig(**ocfg), params,
                                          tgrads, state)
    assert int(state.step) == 8 and state.step.dtype == torch.int32
    np.testing.assert_allclose(m["lr"].numpy(), np.asarray(rm["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(m["grad_norm"].numpy(), gnorm, rtol=1e-6)
    to_np = lambda t: TT._named_from_tree(tcfg, jax.tree.map(np.asarray, t))
    for got, want in ((dict(params.named_parameters()), to_np(rp)),
                      (state.m, to_np(rs.m)), (state.v, to_np(rs.v))):
        for k, w in want.items():
            np.testing.assert_allclose(_np(got[k]), w, rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def test_weight_decay_reaches_norms_and_embedding():
    """With a zero gradient the update is weight decay alone, on every
    parameter: a norm's weight of 1 goes to 1 - lr * wd."""
    _, tcfg = _configs("qwen3-1.7b")
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    before = {n: p.clone() for n, p in params.named_parameters()}
    state = TOpt.init_state(params)
    zero = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    ocfg = TOpt.OptConfig(warmup_steps=1)
    _, _, m = TOpt.apply_updates(ocfg, params, zero, state)
    for n, p in params.named_parameters():
        want = before[n] - m["lr"] * (ocfg.weight_decay * before[n])
        assert torch.equal(p.detach(), want), n
    assert not torch.equal(params.layers[0].qnorm, before["layers.0.qnorm"])


# -- the step -----------------------------------------------------------------

@pytest.fixture(scope="module")
def steps3():
    """Three float32 steps of qwen3 at accum 1 and 2, in both packages, on
    batches of 4 sequences from lm_batch."""
    rcfg, tcfg = _configs("qwen3-1.7b")
    tree = _tree(rcfg)
    batches = [RP.lm_batch(s, 4, T, rcfg.vocab, seed=3) for s in range(3)]
    out = {}
    for accum in (1, 2):
        rstep = jax.jit(RSteps.make_train_step(
            lambda p, b: RT.loss_fn(rcfg, p, b), ROpt.OptConfig(**OPT),
            accum))
        rp, rs, rms = tree, ROpt.init_state(tree), []
        for b in batches:
            rp, rs, m = rstep(rp, rs, b)
            rms.append({k: float(v) for k, v in m.items()})
        params = TT.params_from_jax(tcfg, tree, device="cpu")
        params.requires_grad_(True)
        state = TOpt.init_state(params)
        tstep = TSteps.make_train_step(
            lambda p, b: TT.loss_fn(tcfg, p, b), TOpt.OptConfig(**OPT), accum)
        tms = []
        for b in batches:
            params, state, m = tstep(params, state, b)
            tms.append({k: float(v) for k, v in m.items()})
        out[accum] = dict(
            ref=TT._named_from_tree(tcfg, jax.tree.map(np.asarray, rp)),
            ref_metrics=rms, metrics=tms, state=state,
            params={n: p.detach() for n, p in params.named_parameters()})
    return out


def _params_within_lr(got, want, metrics):
    lr_sum = sum(m["lr"] for m in metrics)
    for k, w in want.items():
        err = float(np.abs(_np(got[k]) - _np(w)).max())
        assert err <= STEPS_LR_BOUND * lr_sum, (k, err / lr_sum)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(steps3, accum):
    run = steps3[accum]
    keys = {"loss", "lr", "grad_norm"} | ({"ce", "router_aux"}
                                          if accum == 1 else set())
    for got, want in zip(run["metrics"], run["ref_metrics"]):
        assert set(got) == set(want) == keys
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=TOL["float32"]), k
    assert int(run["state"].step) == 3
    _params_within_lr(run["params"], run["ref"], run["metrics"])


def test_accumulation_matches_one_batch(steps3):
    """accum=2 splits the batch into rows [0, 2) and [2, 4); the mean of
    the two means is the batch's mean, so the steps agree with accum=1
    within the float32 tolerance, the parameters within lr's bound."""
    one, two = steps3[1], steps3[2]
    for a, b in zip(one["metrics"], two["metrics"]):
        for k in ("loss", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=TOL["float32"]), k
    _params_within_lr(two["params"], one["params"], one["metrics"])

    _, tcfg = _configs("qwen3-1.7b")
    params = TT.params_from_jax(tcfg, _tree(_configs("qwen3-1.7b")[0]),
                                device="cpu").requires_grad_(True)
    batch = RP.lm_batch(0, 4, T, tcfg.vocab, seed=3)
    loss_fn = lambda p, b: TT.loss_fn(tcfg, p, b)
    l1, m1, g1 = TSteps.accumulate_grads(loss_fn, params, batch, 1)
    g1 = {k: g.clone() for k, g in g1.items()}
    l2, m2, g2 = TSteps.accumulate_grads(loss_fn, params, batch, 2)
    assert set(m1) == {"ce", "router_aux"} and m2 == {}
    assert float(l2) == pytest.approx(float(l1), rel=TOL["float32"])
    for k in g1:
        _close_leaf(g2[k], g1[k], TOL["float32"], k)
    with pytest.raises(ValueError):
        TSteps.accumulate_grads(loss_fn, params, batch, 3)


def test_training_needs_gradients_turned_on():
    """The serving weights are frozen; a step on them raises instead of
    updating nothing."""
    _, tcfg = _configs("qwen3-1.7b")
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    step = TSteps.make_train_step(lambda p, b: TT.loss_fn(tcfg, p, b),
                                  TOpt.OptConfig())
    with pytest.raises(ValueError, match="requires_grad_"):
        step(params, TOpt.init_state(params),
             TP.lm_batch(0, 2, T, tcfg.vocab))


def test_eval_step_matches_reference():
    rcfg, tcfg = _configs("minicpm-2b")
    tree = _tree(rcfg)
    batch = TP.lm_batch(4, 2, T, tcfg.vocab, seed=1)
    want = jax.jit(RSteps.make_eval_step(
        lambda p, b: RT.loss_fn(rcfg, p, b)))(tree, batch)
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    params.requires_grad_(True)
    got = TSteps.make_eval_step(lambda p, b: TT.loss_fn(tcfg, p, b))(
        params, batch)
    assert set(got) == set(want) == {"loss", "ce", "router_aux"}
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=TOL["float32"])
    assert got["loss"].grad_fn is None
    assert all(p.grad is None for p in params.parameters())


# -- data and the bound -------------------------------------------------------

@pytest.mark.parametrize("step,batch,seq,vocab,seed", [
    (0, 2, 24, 512, 0), (7, 3, 33, 151_936, 5), (123, 4, 4096, 1000, 2)])
def test_lm_batch_equals_reference_bitwise(step, batch, seq, vocab, seed):
    want = RP.lm_batch(step, batch, seq, vocab, seed)
    got = TP.lm_batch(step, batch, seq, vocab, seed)
    assert got.keys() == want.keys() == {"tokens"}
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    assert np.array_equal(got["tokens"], want["tokens"])


def test_train_roofline_flops_at_reduced():
    """3 x (2 B T (L per_layer + head) + causal attention) at REDUCED
    qwen3: d 64, 4 heads, 2 kv heads, hd 16, d_ff 128, padded vocab 512,
    3 layers, B 2, T 32."""
    _, cfg = _configs("qwen3-1.7b")
    per_layer = 64 * 16 * (2 * 4 + 2 * 2) + 3 * 64 * 128      # 36,864
    head = 512 * 64
    want = 3 * (2 * 2 * 32 * (3 * per_layer + head)
                + 2 * 2 * 3 * 4 * 32 * 32 * 16)
    assert want == 57_409_536
    assert RL.lm_model_flops(cfg, 2, 32, "train") == want
