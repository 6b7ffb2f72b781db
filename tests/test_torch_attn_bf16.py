"""The LM's bf16 score knobs (``attn_p_bf16``, ``attn_scores_bf16``) and
``logits_bf16`` in the port against the reference on the CPU.

The plain attention (``kernels.ref.flash_attention(..., p_bf16=,
scores_bf16=)``, what ``kernels.ops`` runs on a CPU tensor) follows the
reference's rounding points (``repro.models.transformer._attention_scan``).
Held here:

- the attention alone against ``_attention_scan`` at ``kv_block`` 128,
  the port's key block, so p is rounded against the same running max;
- the reduced qwen3 and the reduced llama4 scout (chunked layers, MoE):
  ``prefill`` logits and ``loss_fn`` against the reference's on the same
  weights (``params_from_jax``) and tokens, the reference eager
  (``jax.disable_jit()``, as ``test_torch_lm.py`` says why) at its own
  ``kv_block`` (16: the reference's p is rounded against the running max
  of 16-key blocks, the port's of 128-key blocks);
- one gradient (qwen3, ``attn_scores_bf16``) against ``jax.grad``,
  jitted with ``xla_allow_excess_precision`` off (``test_torch_train.py``),
  the reference at ``kv_block`` 128 so both differentiate the same
  rounding points (at its own 16, ``wk``'s gradient differs by 0.018 of
  the largest);
- ``logits_bf16``: bf16 logits of a float32 model, the loss's logsumexp in
  float32.

Tolerance: ``TOL`` = 2^-6 of the largest magnitude of the reference's
value (``test_torch_lm.py``'s bf16 tolerance). Measured on the CPU: the
attention alone up to 2^-9.7 (p_bf16) and 2^-14.7 (scores_bf16) of its
largest output; prefill logits up to 2^-6.4 (qwen3, scores_bf16), losses
up to 2^-13.7 of their value; the gradient up to 2^-6.04 (0.0152, as
``test_torch_train.py`` measures for the plain bf16 model).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama4_scout_17b_a16e as r_scout
from repro.configs import qwen3_1_7b as r_qwen
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.kernels import autograd as KA
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = {"qwen3-1.7b": r_qwen, "llama4-scout-17b-a16e": r_scout}
KNOBS = ("attn_p_bf16", "attn_scores_bf16")
TOL = 2.0 ** -6
B, T = 2, 24


def _np(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _err(got, want):
    """Largest |got - want| over the largest |want|."""
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("D,H,K,causal", [(16, 4, 2, True), (32, 2, 2, True),
                                          (8, 6, 2, False)])
def test_attention_follows_the_reference_rounding_points(knob, D, H, K,
                                                         causal):
    """ops (the plain version on the CPU) and ref against
    ``_attention_scan`` at kv_block 128 over 300 keys (three blocks)."""
    Tq = 300
    rng = np.random.default_rng(D + H)
    q, k, v = (rng.normal(size=(1, Tq, h, D)).astype(np.float32) * 2
               for h in (H, K, K))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    cfg = RT.LMConfig(n_heads=H, n_kv_heads=K, head_dim=D, kv_block=128,
                      unroll_kv=True, **{knob: True})
    pos = jnp.arange(Tq, dtype=jnp.int32)
    with jax.disable_jit():
        if causal:
            want = RT._attention_scan(qb, kb, vb, pos, pos, cfg, True)
        else:   # every key visible: the mask's positions all at the end
            want = RT._attention_scan(qb, kb, vb, jnp.full_like(pos, Tq),
                                      pos, cfg, True)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16).transpose(1, 2).contiguous()
                  for x in (qb, kb, vb))
    flags = dict(p_bf16=knob == "attn_p_bf16",
                 scores_bf16=knob == "attn_scores_bf16")
    got = ops.flash_attention(tq, tk, tv, causal=causal, **flags)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.flash_attention(tq, tk, tv, causal=causal,
                                                **flags))
    assert _err(got.transpose(1, 2), want) <= TOL
    # float32 inputs are cast to bf16 first: the same values, in float32
    got32 = ops.flash_attention(tq.float(), tk.float(), tv.float(),
                                causal=causal, **flags)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, got.float())


@pytest.fixture(scope="module", params=[(a, k) for a in ARCHS for k in KNOBS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both packages' knobbed prefill and loss on the reference's weights."""
    arch, knob = request.param
    rcfg = dataclasses.replace(ARCHS[arch].REDUCED, **{knob: True})
    tcfg = dataclasses.replace(configs.get(arch).make_reduced(),
                               **{knob: True})
    tree = jax.tree.map(np.asarray,
                        RT.init_params(rcfg, jax.random.PRNGKey(0))[0])
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab, (B, T + 1)).astype(np.int32)
    with jax.disable_jit():
        cache, _ = RT.init_cache(rcfg, B, T)
        rlog, _ = RT.prefill(rcfg, tree, jnp.asarray(toks[:, :T]), cache)
        rloss, _ = RT.loss_fn(rcfg, tree, {"tokens": jnp.asarray(toks)})
    tlog, _ = TT.prefill(tcfg, params, torch.from_numpy(toks[:, :T]),
                         TT.init_cache(tcfg, B, T, "cpu"))
    tloss, _ = TT.loss_fn(tcfg, params, {"tokens": toks})
    return dict(ref=(rlog, rloss), port=(tlog, tloss))


def test_knobbed_prefill_matches_reference(run):
    got, want = run["port"][0], run["ref"][0]
    assert tuple(got.shape) == tuple(want.shape)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= TOL


def test_knobbed_loss_matches_reference(run):
    got, want = float(run["port"][1]), float(run["ref"][1])
    assert math.isfinite(got)
    assert abs(got - want) <= TOL * abs(want)


def test_knobbed_gradient_matches_jax_grad():
    """qwen3 with ``attn_scores_bf16``: every gradient leaf within 2^-6 of
    the largest of ``jax.grad``'s, whose backward runs through the
    reference's bf16 scan; the port's differentiates its plain version
    with the same rounding points."""
    rcfg = dataclasses.replace(r_qwen.REDUCED, attn_scores_bf16=True,
                               kv_block=128)
    tcfg = dataclasses.replace(configs.get("qwen3-1.7b").make_reduced(),
                               attn_scores_bf16=True)
    tree = jax.tree.map(np.asarray,
                        RT.init_params(rcfg, jax.random.PRNGKey(0))[0])
    toks = np.random.default_rng(2).integers(
        0, rcfg.vocab, (B, T + 1)).astype(np.int32)

    def rloss(p, t):
        return RT.loss_fn(rcfg, p, {"tokens": t})[0]
    rg = jax.jit(jax.grad(rloss)).lower(tree, toks).compile(
        compiler_options={"xla_allow_excess_precision": False})(tree, toks)
    want = TT._named_from_tree(tcfg, jax.tree.map(np.asarray, rg))
    params = TT.params_from_jax(tcfg, tree, device="cpu").requires_grad_(True)
    loss, _ = TT.loss_fn(tcfg, params, {"tokens": toks}, impl=KA)
    loss.backward()
    for name, p in params.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert _err(p.grad, want[name]) <= TOL, name


def test_logits_bf16_rounds_the_logits_only():
    """``logits_bf16`` on a float32 model: bf16 logits (the reference's
    ``preferred_element_type``), the loss's logsumexp in float32, within
    the tolerance of the reference's loss."""
    rcfg = dataclasses.replace(r_qwen.REDUCED, dtype=jnp.float32,
                               logits_bf16=True)
    tcfg = dataclasses.replace(configs.get("qwen3-1.7b").make_reduced(),
                               dtype=torch.float32, logits_bf16=True)
    tree = jax.tree.map(np.asarray,
                        RT.init_params(rcfg, jax.random.PRNGKey(0))[0])
    params = TT.params_from_jax(tcfg, tree, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, rcfg.vocab, (B, T + 1)).astype(np.int32)
    logits, _ = TT.forward(tcfg, params, torch.from_numpy(toks[:, :T]))
    assert logits.dtype == torch.bfloat16
    plain, _ = TT.forward(dataclasses.replace(tcfg, logits_bf16=False),
                          params, torch.from_numpy(toks[:, :T]))
    assert torch.equal(logits, plain.to(torch.bfloat16))
    with jax.disable_jit():
        rl, _ = RT.loss_fn(rcfg, tree, {"tokens": jnp.asarray(toks)})
    tl, m = TT.loss_fn(tcfg, params, {"tokens": toks})
    assert tl.dtype == torch.float32
    assert abs(float(tl) - float(rl)) <= TOL * abs(float(rl))
