"""The port's llama4 serving (``repro_torch.models.transformer`` with the
scout and maverick configs) against the reference's on the CPU.

Both reduced configs run in both packages on the same weights
(``params_from_jax``) and the same tokens, made from a numpy seed:
``prefill`` logits and cache, then three ``decode_step``s with their cache,
in float32 and in bf16. B = 2, T = 24: the prompt fills three chunks of 8,
so each chunked layer's prefill attention is one call over the whole
chunks. Lane 0 decodes from 24, the first position of a new chunk; lane 1
from 22, so its third step crosses into that chunk. Scout's layers are all
MoE, maverick's alternate dense and MoE (``moe_every`` 2); with
``global_every`` 2, layers 1 and 3 are global without RoPE.

The reference runs eagerly (``jax.disable_jit()``), as in
``test_torch_lm.py``, with that file's tolerances on the largest magnitude
of the reference's output: float32 2e-5, bf16 2^-6.

``_moe_ffn`` alone, in float32, at capacities that drop tokens and with
duplicated rows (equal routings, which the stable sort keeps in token
order): the experts and the kept set equal the reference's, the outputs
allclose (rtol 1e-5, atol 1e-6: the expert products' float32 sums), and the
aux loss within rtol 1e-6 (a mean of probabilities, summed in another
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama4_maverick_400b_a17b as r_maverick
from repro.configs import llama4_scout_17b_a16e as r_scout
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = {"llama4-scout-17b-a16e": r_scout,
         "llama4-maverick-400b-a17b": r_maverick}
LOWERING = ("kv_block", "scan_layers", "unroll_kv", "logits_bf16")
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
B, T, STEPS = 2, 24, 3


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _close(got, want, dtype):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def _configs(arch, dtype="bfloat16"):
    rcfg = ARCHS[arch].REDUCED
    tcfg = configs.get(arch).REDUCED
    if dtype == "float32":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return rcfg, tcfg


def _tree(rcfg):
    return jax.tree.map(np.asarray,
                        RT.init_params(rcfg, jax.random.PRNGKey(0))[0])


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both packages through prefill and three decode steps."""
    arch, dtype = request.param
    rcfg, tcfg = _configs(arch, dtype)
    tree = _tree(rcfg)
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab, (B, T + STEPS)).astype(np.int32)
    cur = [np.array([T + s, T - 2 + s], np.int32) for s in range(STEPS)]
    out = {"dtype": dtype, "ref": {}, "port": {}}
    with jax.disable_jit():
        cache, _ = RT.init_cache(rcfg, B, T + 8)
        logits, cache = RT.prefill(rcfg, tree, jnp.asarray(toks[:, :T]),
                                   cache)
        out["ref"]["prefill"] = (logits, cache)
        steps = []
        for s in range(STEPS):
            logits, cache = RT.decode_step(rcfg, tree, cache,
                                           jnp.asarray(toks[:, T + s]),
                                           jnp.asarray(cur[s]))
            steps.append((logits, cache))
        out["ref"]["decode"] = steps
    ttoks = torch.from_numpy(toks)
    cache = TT.init_cache(tcfg, B, T + 8, device="cpu")
    logits, cache = TT.prefill(tcfg, params, ttoks[:, :T], cache)
    out["port"]["prefill"] = (logits, {k: v.clone() for k, v in
                                       cache.items()})
    steps = []
    for s in range(STEPS):
        logits, cache = TT.decode_step(tcfg, params, cache, ttoks[:, T + s],
                                       torch.from_numpy(cur[s]))
        steps.append((logits, {k: v.clone() for k, v in cache.items()}))
    out["port"]["decode"] = steps
    return out


def test_prefill_matches_reference(run):
    (gl, gc), (wl, wc) = run["port"]["prefill"], run["ref"]["prefill"]
    assert tuple(gl.shape) == tuple(wl.shape)
    _close(gl, wl, run["dtype"])
    for name in ("k", "v"):
        assert tuple(gc[name].shape) == tuple(wc[name].shape)
        _close(gc[name], wc[name], run["dtype"])
        assert not bool(gc[name][:, :, T:].any())     # zero past the prompt


def test_decode_steps_match_reference(run):
    for (gl, gc), (wl, wc) in zip(run["port"]["decode"],
                                  run["ref"]["decode"]):
        _close(gl, wl, run["dtype"])
        for name in ("k", "v"):
            _close(gc[name], wc[name], run["dtype"])


def _ref_routing(rcfg, lw, x2d):
    """The reference's experts and kept tokens, from the lines of its
    ``_moe_ffn`` that compute them."""
    n, e = x2d.shape[0], rcfg.n_experts
    cap = max(8, int(rcfg.capacity_factor * n / e))
    probs = jax.nn.softmax(x2d.astype(jnp.float32)
                           @ lw["router"].astype(jnp.float32), axis=-1)
    eidx = np.asarray(jnp.argmax(probs, axis=-1))
    order = np.asarray(jnp.argsort(eidx))
    se = eidx[order]
    pos = np.arange(n) - np.maximum.accumulate(
        np.where(np.r_[True, se[1:] != se[:-1]], np.arange(n), 0))
    kept = np.zeros(n, bool)
    kept[order] = pos < cap
    return eidx, kept


@pytest.mark.parametrize("arch,n,factor,dup", [
    ("llama4-scout-17b-a16e", 48, 1.25, False),
    ("llama4-scout-17b-a16e", 48, 0.5, False),
    ("llama4-scout-17b-a16e", 48, 1.25, True),
    ("llama4-maverick-400b-a17b", 200, 1.0, True),
])
def test_moe_ffn_matches_reference(arch, n, factor, dup):
    rcfg, tcfg = _configs(arch, "float32")
    rcfg = dataclasses.replace(rcfg, capacity_factor=factor)
    tcfg = dataclasses.replace(tcfg, capacity_factor=factor)
    tree = _tree(rcfg)
    li = 1                                   # a MoE layer of both configs
    lw = {k: jnp.asarray(tree["layers"][k][li])
          for k in ("router", "e_gate", "e_up", "e_down")}
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    x = np.random.default_rng(n).normal(size=(n, rcfg.d_model)).astype(
        np.float32)
    if dup:                                  # each row twice: equal routings
        x[n // 2:] = x[:n // 2]
    with jax.disable_jit():
        want, want_aux = RT._moe_ffn(rcfg, lw, jnp.asarray(x))
    eidx, kept = _ref_routing(rcfg, lw, jnp.asarray(x))
    blk = params.layers[li]
    got, aux = TT._moe_ffn(tcfg, blk, torch.from_numpy(x))
    r = TT.route(tcfg, blk.router, torch.from_numpy(x))
    got_kept = np.zeros(n, bool)
    got_kept[r.order.numpy()] = r.keep.numpy()
    assert np.array_equal(r.eidx.numpy(), eidx)
    assert np.array_equal(got_kept, kept)
    assert 0 < kept.sum() < n                # the case drops tokens
    assert np.array_equal(np.asarray(want).any(axis=1), kept)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if dup:
        assert np.array_equal(eidx[n // 2:], eidx[:n // 2])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_parameters_number_param_count(arch):
    """The port holds the experts on MoE layers only, so its parameters
    number exactly ``param_count()``, the reference's count (which also
    leaves the dense layers' unused expert leaves out)."""
    rcfg, tcfg = _configs(arch)
    tree = _tree(rcfg)
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    n = sum(p.numel() for p in params.parameters())
    assert n == tcfg.param_count() == rcfg.param_count() == 566_848
    assert tcfg.active_param_count() == rcfg.active_param_count()
    moe = [i for i in range(tcfg.n_layers) if tcfg._is_moe(i)]
    assert moe == ([0, 1, 2, 3] if "scout" in arch else [1, 3])
    for i, blk in enumerate(params.layers):
        assert blk.moe == (i in moe)
        assert hasattr(blk, "e_gate") == (i in moe)
        if i in moe:
            for k in ("router", "e_gate", "e_up", "e_down"):
                assert np.array_equal(getattr(blk, k).numpy(),
                                      tree["layers"][k][i])
    init = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert ({n: p.shape for n, p in init.named_parameters()}
            == {n: p.shape for n, p in params.named_parameters()})
    e_down = init.layers[moe[0]].e_down           # fan-in d_ff
    assert abs(float(e_down.std()) * tcfg.d_ff ** 0.5 - 1.0) < 0.1


def test_configs_copy_the_reference():
    for arch, rmod in ARCHS.items():
        tmod = configs.get(arch)
        for which in ("CONFIG", "REDUCED"):
            tcfg, rcfg = getattr(tmod, which), getattr(rmod, which)
            assert {f.name for f in dataclasses.fields(tcfg)} == \
                {f.name for f in dataclasses.fields(rcfg)} - set(LOWERING)
            for f in dataclasses.fields(tcfg):
                if f.name in ("dtype", "param_dtype"):
                    continue
                assert getattr(tcfg, f.name) == getattr(rcfg, f.name), \
                    (arch, which, f.name)
            assert tcfg.param_count() == rcfg.param_count()
            assert tcfg.active_param_count() == rcfg.active_param_count()
            assert tcfg.dtype == torch.bfloat16


@pytest.mark.parametrize("t,chunked", [
    (20, [(2 * 2, 8), (2, 4)]),     # two whole chunks and a tail
    (16, [(2 * 2, 8)]),             # whole chunks only
    (8, [(2, 8)]),                  # one chunk
    (5, [(2, 5)]),                  # shorter than a chunk
])
def test_chunked_prefill_calls_the_kernel_wrapper(monkeypatch, t, chunked):
    """A chunked layer's prefill attention is one ops.flash_attention call
    over the whole chunks [B * (T // C), H, C, Dh] and one over the tail
    [B, H, T % C, Dh]; a global layer's is one call over the prompt."""
    cfg = configs.get("llama4-scout-17b-a16e").REDUCED
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    TT.prefill(cfg, params, torch.zeros((2, t), dtype=torch.long),
               TT.init_cache(cfg, 2, t + 2, "cpu"))
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def call(b, n):
        return ((b, H, n, Dh), (b, K, n, Dh), True)

    layer_c = [call(b, n) for b, n in chunked]       # layers 0 and 2
    layer_g = [call(2, t)]                           # layers 1 and 3 (NoPE)
    assert calls == (layer_c + layer_g) * 2


def test_serving_copy_computes_the_same_values():
    """cast_matrices stores the matrices and expert tensors in bf16 and
    keeps the router in float32, so prefill and decode give the same bits."""
    cfg = configs.get("llama4-maverick-400b-a17b").REDUCED
    params = TT.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 19)).astype(np.int64))
    want, wc = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 21, "cpu"))
    want2, _ = TT.decode_step(cfg, params, wc, toks[:, 0],
                              torch.tensor([19, 19]))
    served = TT.cast_matrices(params, cfg.dtype)
    blk = served.layers[1]
    assert blk.e_gate.dtype == blk.wq.dtype == torch.bfloat16
    assert blk.router.dtype == blk.ln1.dtype == torch.float32
    got, gc = TT.prefill(cfg, served, toks, TT.init_cache(cfg, 2, 21, "cpu"))
    got2, _ = TT.decode_step(cfg, served, gc, toks[:, 0],
                             torch.tensor([19, 19]))
    assert torch.equal(got, want) and torch.equal(got2, want2)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_training_raises_and_names_its_slice(arch):
    """llama4 trains since its training slice: ``forward`` returns the
    logits and the router aux loss summed over the MoE layers, and
    ``loss_fn``'s total adds ``router_aux_weight`` times it (the
    gradients are held in ``test_torch_llama4_train.py``); only the bf16
    score knobs still raise."""
    cfg = configs.get(arch).REDUCED
    params = TT.init_params(cfg, torch.Generator(), device="cpu")
    toks = torch.zeros((1, 9), dtype=torch.long)
    logits, aux = TT.forward(cfg, params, toks[:, :-1])
    assert tuple(logits.shape) == (1, 8, cfg.padded_vocab)
    assert aux.dtype == torch.float32 and float(aux) > 0
    total, m = TT.loss_fn(cfg, params, {"tokens": toks})
    assert float(m["router_aux"]) == float(aux)
    assert float(total) == pytest.approx(
        float(m["ce"]) + cfg.router_aux_weight * float(aux), rel=1e-6)
    with pytest.raises(NotImplementedError, match="slice"):
        TT.forward(dataclasses.replace(cfg, attn_p_bf16=True), params,
                   toks[:, :-1])


def test_lm_model_flops_counts_moe_and_chunks():
    """By hand at REDUCED: d 64, 8 heads, 2 kv heads, hd 8, d_ff 128,
    padded vocab 512, chunk 8, layers 1 and 3 global; B 2, T 20."""
    proj, ffn, head = 64 * 8 * (2 * 8 + 2 * 2), 3 * 64 * 128, 512 * 64
    scout = configs.get("llama4-scout-17b-a16e").REDUCED      # 4 experts
    maverick = configs.get("llama4-maverick-400b-a17b").REDUCED
    moe4 = proj + 2 * ffn + 64 * 4       # top-1 + shared expert + router
    moe8 = proj + 2 * ffn + 64 * 8
    w_scout, w_mav = 4 * moe4, 2 * (proj + ffn) + 2 * moe8
    assert (w_scout, w_mav) == (238_592, 189_440)
    sq = 2 * (8 * 8 + 8 * 8 + 4 * 4) + 2 * 20 * 20  # chunked, then global
    keys = 2 * (20 % 8 + 1) + 2 * 21                # decode at position 20
    for cfg, w in ((scout, w_scout), (maverick, w_mav)):
        assert RL.lm_model_flops(cfg, 2, 20, "prefill") == \
            2 * 2 * 20 * w + 2 * 2 * 8 * sq * 8 + 2 * 2 * head
        assert RL.lm_model_flops(cfg, 2, 20, "decode") == \
            2 * 2 * (w + head) + 4 * 2 * 8 * keys * 8
        assert RL.lm_model_flops(cfg, 2, 20, "train") == \
            3 * (2 * 2 * 20 * (w + head) + 2 * 2 * 8 * sq * 8)
    assert RL.lm_model_flops(scout, 2, 20, "prefill") == 19_496_960
    # without chunks every layer attends over the whole prompt
    flat = dataclasses.replace(scout, attn_chunk=0)
    assert RL.lm_model_flops(flat, 2, 20, "prefill") == \
        2 * 2 * 20 * w_scout + 2 * 2 * 8 * 4 * 400 * 8 + 2 * 2 * head
