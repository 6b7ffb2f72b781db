"""Dense decoder-only LM on PyTorch (counterpart of
``repro.models.transformer``): serving through ``prefill`` and
``decode_step``, and the teacher-forcing ``forward``.

Covers the dense configs (qwen3, minicpm, gemma): GQA with a separate
head_dim, qk-norm, SwiGLU or GeGLU, tied embeddings, RoPE, embedding and
residual scaling, (1 + w) RMSNorm. Parameters are an ``LM`` module whose
names are the reference's keys (``embed``, ``final_norm`` and per layer
``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``gate``, ``up``,
``down``, ``qnorm``, ``knorm``), one ``Block`` per layer where the
reference stacks them ``[L, ...]``.

The arithmetic follows the reference op for op: weights are cast to the
compute dtype at each use, norms and rope run in float32 and cast back, the
embedding scale, residual scale and adds and the activations run in the
compute dtype with the scalars rounded to it (``layers.scalar``). Prefill's
and forward's attention is ``kernels.ops.flash_attention`` (the
hand-written CUDA kernel on the card, its plain version on the CPU;
``prefill(..., impl=kernels.ref)`` runs the plain version on the card),
which computes the reference's online-softmax scan in
float32 (the reference's ``_attention_scan`` is the same function, causal
from position 0). Decode attends over the cache in plain torch with the
reference's two-pool merge, as the reference does without a kernel.

The cache is updated in place: ``prefill`` writes positions [0, T) and
zeroes the rest, ``decode_step`` writes the new token's k/v at ``cur_pos``.
For finite values that equals the reference's padded copy and one-hot
blend, without copying the cache each step.

Everything here is inference: the flash kernel has no backward, so the
entry points run under ``torch.no_grad`` (training is a later slice).
Configs this slice cannot serve raise ``NotImplementedError``: MoE layers,
chunked (iRoPE/NoPE) attention and the bf16 score knobs. ``LMConfig`` has
no fields for the reference's XLA lowering knobs (``kv_block``,
``scan_layers``, ``unroll_kv``, ``remat_policy``), its MoE routing knobs or
``logits_bf16``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels import ops
from .layers import gelu, rms_norm, rope, scalar, silu

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"                 # "silu" | "gelu" (GeGLU, tanh form)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    n_experts: int = 0                # MoE: a later slice
    attn_chunk: int = 0               # chunked attention: a later slice
    emb_scale: float = 1.0
    resid_scale: float = 1.0
    norm_plus_one: bool = False       # gemma-style (1 + w) RMSNorm
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    vocab_pad: int = 128
    attn_p_bf16: bool = False         # bf16 score knobs: a later slice
    attn_scores_bf16: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + self.vocab_pad - 1)
                // self.vocab_pad) * self.vocab_pad

    def param_count(self) -> int:
        attn = self.d_model * self.hd * (2 * self.n_heads
                                         + 2 * self.n_kv_heads)
        layer = attn + 3 * self.d_model * self.d_ff + 2 * self.d_model
        return (self.padded_vocab * self.d_model + self.n_layers * layer
                + self.d_model)


def check_supported(cfg: LMConfig) -> None:
    """Raise NotImplementedError for what this slice of the port lacks."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (n_experts={cfg.n_experts}) come with "
            "the llama4 slice of the port (MoE and chunked attention)")
    if cfg.attn_chunk > 0:
        raise NotImplementedError(
            f"{cfg.name}: chunked/NoPE attention (attn_chunk="
            f"{cfg.attn_chunk}) comes with the llama4 slice of the port")
    if cfg.attn_p_bf16 or cfg.attn_scores_bf16:
        raise NotImplementedError(
            f"{cfg.name}: the flash-attention kernel computes scores and "
            "probabilities in float32; the bf16 score knobs come with a "
            "later slice of the port")
    if cfg.act not in ("silu", "gelu"):
        raise ValueError(f"act must be 'silu' or 'gelu', got {cfg.act!r}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer's weights, named as the reference's ``layers`` keys."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        D, H, K, Dh, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cfg.d_ff)
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.ln1 = nn.Parameter(torch.ones(D, **kw))
        self.ln2 = nn.Parameter(torch.ones(D, **kw))
        self.wq = nn.Parameter(torch.empty(D, H * Dh, **kw))
        self.wk = nn.Parameter(torch.empty(D, K * Dh, **kw))
        self.wv = nn.Parameter(torch.empty(D, K * Dh, **kw))
        self.wo = nn.Parameter(torch.empty(H * Dh, D, **kw))
        self.gate = nn.Parameter(torch.empty(D, Fd, **kw))
        self.up = nn.Parameter(torch.empty(D, Fd, **kw))
        self.down = nn.Parameter(torch.empty(Fd, D, **kw))
        if cfg.qk_norm:
            self.qnorm = nn.Parameter(torch.ones(Dh, **kw))
            self.knorm = nn.Parameter(torch.ones(Dh, **kw))


class LM(nn.Module):
    """The LM's weights: tied ``embed`` [V, D], ``final_norm`` [D] and one
    ``Block`` per layer in ``layers``."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        check_supported(cfg)
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.embed = nn.Parameter(torch.empty(cfg.padded_vocab, cfg.d_model,
                                              **kw))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, **kw))
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))


_MATRICES = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights, the reference's scheme: matrices N(0, 1) /
    sqrt(fan_in) in ``param_dtype``, norms at 1. ``generator`` lives on
    the target device (the numbers differ from jax.random's; tests carry
    the reference's weights across with ``params_from_jax``)."""
    dev = resolve_device(device)
    model = LM(cfg, dev)

    def nrm(p: nn.Parameter, fan_in: int) -> None:
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                                dtype=cfg.param_dtype) / math.sqrt(fan_in))

    nrm(model.embed, cfg.d_model)
    for blk in model.layers:
        for name in _MATRICES:
            p = getattr(blk, name)
            nrm(p, p.shape[0])        # [fan_in, fan_out]
    return model.requires_grad_(False)


def params_from_jax(cfg: LMConfig, tree, device=None) -> LM:
    """The reference's parameter tree as an ``LM``.

    ``tree`` is ``jax.tree.map(np.asarray, init_params(cfg, key)[0])``:
    ``embed``, ``final_norm`` and ``layers`` of arrays stacked [L, ...].
    Values are copied as they are, so both packages compute on the same
    weights."""
    dev = resolve_device(device)
    model = LM(cfg, dev).requires_grad_(False)

    def put(p: nn.Parameter, a) -> None:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"shape {a.shape}, expected {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))   # a writable copy

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    layers = tree["layers"]
    for i, blk in enumerate(model.layers):
        for name, p in blk.named_parameters():
            put(p, layers[name][i])
    return model


def cast_matrices(params: LM, dtype: torch.dtype) -> LM:
    """Store every weight matrix in ``dtype`` (the compute dtype), in place;
    the norm vectors stay as they are.

    Every use casts a matrix to the compute dtype first, so a model cast
    this way computes the same values without a cast of all its weights on
    each call (qwen3-1.7b holds 6.9 GB in float32); the float32 masters are
    dropped, so this is for serving."""
    for p in params.parameters():
        if p.dim() >= 2:
            p.data = p.data.to(dtype)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _dense_ffn(cfg: LMConfig, lw: Block, x: torch.Tensor) -> torch.Tensor:
    g = x @ lw.gate.to(x.dtype)
    u = x @ lw.up.to(x.dtype)
    g = silu(g) if cfg.act == "silu" else gelu(g)
    return (g * u) @ lw.down.to(x.dtype)


def _qkv(cfg: LMConfig, lw: Block, x: torch.Tensor, pos: torch.Tensor):
    """Projections, qk-norm and rope. x [B, T, D], pos [B, T] ->
    q [B, T, H, Dh], k/v [B, T, K, Dh]."""
    B, T, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lw.ln1, plus_one=cfg.norm_plus_one)
    q = (h @ lw.wq.to(h.dtype)).reshape(B, T, H, Dh)
    k = (h @ lw.wk.to(h.dtype)).reshape(B, T, K, Dh)
    v = (h @ lw.wv.to(h.dtype)).reshape(B, T, K, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lw.qnorm)
        k = rms_norm(k, lw.knorm)
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _mlp_residual(cfg: LMConfig, lw: Block, x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
    """Output projection, residual, FFN, residual. attn [B, T, H*Dh]."""
    rs = scalar(cfg.resid_scale, x.dtype)
    x = x + rs * (attn @ lw.wo.to(x.dtype))
    h2 = rms_norm(x, lw.ln2, plus_one=cfg.norm_plus_one)
    return x + rs * _dense_ffn(cfg, lw, h2)


def _block(cfg: LMConfig, lw: Block, x: torch.Tensor, pos: torch.Tensor,
           impl=ops):
    """One layer over a whole prompt from position 0. x [B, T, D].
    Returns (x, k, v) with k/v [B, T, K, Dh]."""
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, lw, x, pos)
    attn = impl.flash_attention(q.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(), causal=True)
    attn = attn.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.hd)
    return _mlp_residual(cfg, lw, x, attn), k, v


def _block_decode(cfg: LMConfig, lw: Block, x: torch.Tensor,
                  pos_q: torch.Tensor, pos_k: torch.Tensor,
                  kc: torch.Tensor, vc: torch.Tensor):
    """One layer for one new token per lane. x [B, 1, D], pos_q [B, 1],
    pos_k [S], kc/vc [B, S, K, Dh] (the cache before this step).

    Attention is the reference's two-pool merge in float32: the cache's
    strictly earlier positions and the new token itself, combined through
    one max. Returns (x, k, v) with the new token's k/v [B, 1, K, Dh]."""
    B, T, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, kn, vn = _qkv(cfg, lw, x, pos_q)
    mask_prev = (pos_k[None, :] < pos_q)[:, None, None, None, :]
    qf = q.reshape(B, T, K, H // K, Dh).float() / math.sqrt(Dh)
    s_self = torch.einsum("btkgd,btkd->btkg", qf, kn.float())
    s_prev = torch.einsum("btkgd,bskd->btkgs", qf, kc.float())
    s_prev = torch.where(mask_prev, s_prev, -math.inf)
    m_all = torch.maximum(s_prev.amax(dim=-1), s_self)
    m_safe = torch.where(torch.isfinite(m_all), m_all, 0.0)
    p_prev = torch.where(mask_prev, torch.exp(s_prev - m_safe[..., None]),
                         0.0)
    p_self = torch.exp(s_self - m_safe)
    denom = torch.sum(p_prev, dim=-1) + p_self
    out = (torch.einsum("btkgs,bskd->btkgd", p_prev, vc.float())
           + p_self[..., None] * vn.float()[:, :, :, None, :])
    attn = (out / torch.clamp_min(denom[..., None], 1e-30)).reshape(
        B, T, H * Dh).to(x.dtype)
    return _mlp_residual(cfg, lw, x, attn), kn, vn


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _embed(cfg: LMConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    return (params.embed[tokens.long()].to(cfg.dtype)
            * scalar(cfg.emb_scale, cfg.dtype))


def _logits(cfg: LMConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, plus_one=cfg.norm_plus_one)
    return x @ params.embed.to(x.dtype).T


@torch.no_grad()
def forward(cfg: LMConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing forward. tokens int [B, T] -> logits [B, T, V] in
    the compute dtype. (The reference also returns the MoE router's aux
    loss, which is 0 for a dense config.)"""
    check_supported(cfg)
    B, T = tokens.shape
    x = _embed(cfg, params, tokens)
    pos = torch.arange(T, device=x.device).expand(B, T)
    for lw in params.layers:
        x, _, _ = _block(cfg, lw, x, pos, ops)
    return _logits(cfg, params, x)


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None) -> Cache:
    """KV cache {"k", "v"}, each [L, B, S, K, Dh] zeros in the compute
    dtype."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


@torch.no_grad()
def prefill(cfg: LMConfig, params: LM, tokens: torch.Tensor, cache: Cache,
            impl=ops) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt tokens int [B, T]; write cache[:, :, :T] and zero the
    rest (in place); return (last-position logits [B, V], cache).

    ``impl`` supplies ``flash_attention``: ``kernels.ops`` (the default) or
    ``kernels.ref`` to run the plain version on the card."""
    check_supported(cfg)
    B, T = tokens.shape
    x = _embed(cfg, params, tokens)
    pos = torch.arange(T, device=x.device).expand(B, T)
    for i, lw in enumerate(params.layers):
        x, k, v = _block(cfg, lw, x, pos, impl)
        cache["k"][i, :, :T] = k
        cache["v"][i, :, :T] = v
    cache["k"][:, :, T:] = 0
    cache["v"][:, :, T:] = 0
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(cfg: LMConfig, params: LM, cache: Cache, token: torch.Tensor,
                cur_pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token int [B]; cur_pos int [B] (each lane's cache
    length, below S). Attends over cache positions < cur_pos plus the new
    token, then writes its k/v at cur_pos in place. Returns (logits [B, V],
    cache)."""
    check_supported(cfg)
    S = cache["k"].shape[2]
    x = _embed(cfg, params, token[:, None])
    cur = cur_pos.long()
    pos_q = cur[:, None]
    pos_k = torch.arange(S, device=x.device)
    ks, vs = [], []
    for i, lw in enumerate(params.layers):
        x, k, v = _block_decode(cfg, lw, x, pos_q, pos_k, cache["k"][i],
                                cache["v"][i])
        ks.append(k[:, 0])
        vs.append(v[:, 0])
    lanes = torch.arange(x.shape[0], device=x.device)
    cache["k"][:, lanes, cur] = torch.stack(ks)
    cache["v"][:, lanes, cur] = torch.stack(vs)
    return _logits(cfg, params, x)[:, 0], cache
