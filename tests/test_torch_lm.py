"""The port's dense LM (``repro_torch.models.transformer``) against the
reference's (``repro.models.transformer``) on the CPU.

The reduced qwen3, minicpm and gemma configs run in both packages on the
same weights (``params_from_jax``) and the same tokens, made from a numpy
seed: ``forward`` logits, ``prefill`` logits and cache, and three
``decode_step``s with their cache, in float32 and in bf16.

The reference runs eagerly (``jax.disable_jit()``), which rounds every bf16
op to bf16 as eager torch does. Under ``jit`` XLA fuses chains of bf16 ops
and keeps their intermediates in float32, so the reference's own jitted
logits differ from its eager ones by up to 3% of the largest logit on these
configs; the port follows the op-by-op semantics.

Tolerances, on the largest magnitude of the reference's output: float32
2e-5 (measured up to 2.3e-6: the attention's float32 sums run in another
order); bf16 2^-6, two bf16 rounding steps at the top of the range
(measured up to 2^-7.6: the port's attention is the flash kernel's
arithmetic, q scaled by a multiply and keys in blocks of 128, where the
reference's scan divides and takes blocks of ``kv_block``, and a float32
difference that crosses a bf16 rounding boundary moves a value by one
step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_7b as r_gemma
from repro.configs import minicpm_2b as r_minicpm
from repro.configs import qwen3_1_7b as r_qwen
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = {"qwen3-1.7b": r_qwen, "minicpm-2b": r_minicpm,
         "gemma-7b": r_gemma}
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
B, T, STEPS = 2, 24, 3


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _close(got, want, dtype):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def _configs(arch, dtype):
    rcfg = ARCHS[arch].REDUCED
    tcfg = configs.get(arch).REDUCED
    if dtype == "float32":
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return rcfg, tcfg


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both packages through forward, prefill and three decode steps."""
    arch, dtype = request.param
    rcfg, tcfg = _configs(arch, dtype)
    tree = jax.tree.map(np.asarray,
                        RT.init_params(rcfg, jax.random.PRNGKey(0))[0])
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab, (B, T + STEPS)).astype(np.int32)
    # lane 1 decodes from an earlier position and overwrites its cache
    cur = [np.array([T + s, T - 3 + s], np.int32) for s in range(STEPS)]
    out = {"dtype": dtype, "ref": {}, "port": {}}
    with jax.disable_jit():
        out["ref"]["forward"] = RT.forward(rcfg, tree,
                                           jnp.asarray(toks[:, :T]))[0]
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
    out["port"]["forward"], aux = TT.forward(tcfg, params, ttoks[:, :T])
    assert aux.dtype == torch.float32 and float(aux) == 0.0   # dense
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


def test_forward_matches_reference(run):
    got, want = run["port"]["forward"], run["ref"]["forward"]
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, run["dtype"])


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


def test_serving_copy_computes_the_same_values():
    """cast_matrices stores the matrices in bf16; every use casts them to
    bf16 anyway, so prefill and decode give the same bits."""
    cfg = configs.get("gemma-7b").REDUCED
    g = torch.Generator().manual_seed(3)
    params = TT.init_params(cfg, g, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 10)).astype(np.int64))
    want, wc = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 12, "cpu"))
    want2, _ = TT.decode_step(cfg, params, wc, toks[:, 0],
                              torch.tensor([10, 10]))
    served = TT.cast_matrices(params, cfg.dtype)
    assert served.layers[0].wq.dtype == torch.bfloat16
    assert served.layers[0].ln1.dtype == torch.float32
    got, gc = TT.prefill(cfg, served, toks, TT.init_cache(cfg, 2, 12, "cpu"))
    got2, _ = TT.decode_step(cfg, served, gc, toks[:, 0],
                             torch.tensor([10, 10]))
    assert torch.equal(got, want) and torch.equal(got2, want2)


def test_init_params_follows_the_reference_scheme():
    cfg = configs.get("qwen3-1.7b").REDUCED
    a = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = RT.init_params(r_qwen.REDUCED, jax.random.PRNGKey(0))[0]
    names = {n for n, _ in a.named_parameters()}
    assert names == ({"embed", "final_norm"}
                     | {f"layers.{i}.{k}" for i in range(cfg.n_layers)
                        for k in tree["layers"]})
    for name, p in a.named_parameters():
        assert torch.equal(p, dict(b.named_parameters())[name])
        key = name.split(".")[-1]
        ref = np.asarray(tree[key] if key in tree else tree["layers"][key][0])
        assert tuple(p.shape) == ref.shape and p.dtype == torch.float32
        if p.dim() == 1:
            assert bool((p == 1).all())
        else:
            fan_in = p.shape[1] if key == "embed" else p.shape[0]
            assert abs(float(p.std()) * fan_in ** 0.5 - 1.0) < 0.1


def test_configs_copy_the_reference():
    for arch, rmod in ARCHS.items():
        tmod = configs.get(arch)
        for which in ("CONFIG", "REDUCED"):
            tcfg, rcfg = getattr(tmod, which), getattr(rmod, which)
            for f in dataclasses.fields(tcfg):
                if f.name in ("dtype", "param_dtype"):
                    continue
                assert getattr(tcfg, f.name) == getattr(rcfg, f.name), \
                    (arch, which, f.name)
            assert tcfg.param_count() == rcfg.param_count()
            assert tcfg.dtype == torch.bfloat16
    with pytest.raises(KeyError, match="not ported"):
        configs.get("jag-billion")


@pytest.mark.parametrize("change", [dict(n_experts=4), dict(attn_chunk=8),
                                    dict(attn_p_bf16=True),
                                    dict(attn_scores_bf16=True)])
def test_configs_of_later_slices_raise(change):
    """MoE and chunked configs serve and train (the MoE's aux loss is
    positive, a chunked config's 0); the bf16 score knobs raise
    everywhere."""
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").REDUCED, **change)
    toks = torch.zeros((1, 4), dtype=torch.long)
    if "n_experts" in change or "attn_chunk" in change:
        params = TT.init_params(cfg, torch.Generator(), device="cpu")
        logits, aux = TT.forward(cfg, params, toks)
        assert tuple(logits.shape) == (1, 4, cfg.padded_vocab)
        assert (float(aux) > 0) == ("n_experts" in change)
        total, m = TT.loss_fn(cfg, params, {"tokens": toks})
        assert float(total) == pytest.approx(
            float(m["ce"]) + cfg.router_aux_weight * float(m["router_aux"]))
        logits, _ = TT.prefill(cfg, params, toks,
                               TT.init_cache(cfg, 1, 4, "cpu"))
        assert bool(torch.isfinite(logits).all())
        return
    with pytest.raises(NotImplementedError, match="slice"):
        TT.init_params(cfg, torch.Generator(), device="cpu")
    ok = configs.get("qwen3-1.7b").REDUCED
    params = TT.init_params(ok, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        TT.forward(cfg, params, toks)
    with pytest.raises(NotImplementedError, match="slice"):
        TT.prefill(cfg, params, toks, TT.init_cache(ok, 1, 4, "cpu"))


def test_prefill_attention_goes_through_the_kernel_wrapper(monkeypatch):
    """Every layer's prefill attention is one ops.flash_attention call."""
    cfg = configs.get("qwen3-1.7b").REDUCED
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    TT.prefill(cfg, params, torch.zeros((2, 7), dtype=torch.long),
               TT.init_cache(cfg, 2, 9, "cpu"))
    assert calls == [((2, cfg.n_heads, 7, cfg.hd),
                      (2, cfg.n_kv_heads, 7, cfg.hd), True)] * cfg.n_layers
