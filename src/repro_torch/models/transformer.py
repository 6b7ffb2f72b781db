"""Decoder-only LM on PyTorch (counterpart of
``repro.models.transformer``): serving through ``prefill`` and
``decode_step``, and training through the teacher-forcing ``forward`` and
``loss_fn``.

Covers the dense configs (qwen3, minicpm, gemma): GQA with a separate
head_dim, qk-norm, SwiGLU or GeGLU, tied embeddings, RoPE, embedding and
residual scaling, (1 + w) RMSNorm; and the llama4 configs: top-1 MoE
with capacity and the shared expert on every ``moe_every``-th layer, and
iRoPE, where three of every ``global_every`` layers attend
within chunks of ``attn_chunk`` positions with RoPE and the last is
global without it (NoPE). Parameters are an ``LM`` module whose names are
the reference's keys (``embed``, ``final_norm`` and per layer ``ln1``,
``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``gate``, ``up``, ``down``,
``qnorm``, ``knorm``, ``router``, ``e_gate``, ``e_up``, ``e_down``), one
``Block`` per layer where the reference stacks them ``[L, ...]``.

Deviation: a ``Block`` holds ``router`` [D, E], ``e_gate``/``e_up`` [E, D,
F] and ``e_down`` [E, F, D] on MoE layers only (``LMConfig._is_moe``). The
reference gives every layer of a MoE config these leaves, and its dense
layers never read them (maverick's would hold 16.1B unused parameters a
layer), so the port's parameters number exactly ``param_count()``.

The arithmetic follows the reference op for op: weights are cast to the
compute dtype at each use, norms and rope run in float32 and cast back, the
embedding scale, residual scale and adds and the activations run in the
compute dtype with the scalars rounded to it (``layers.scalar``); the
router runs in float32. Prefill's and forward's attention is
``kernels.ops.flash_attention`` (the hand-written CUDA kernel on the card,
its plain version on the CPU; ``prefill(..., impl=kernels.ref)`` runs the
plain version on the card), which computes the reference's online-softmax
scan in float32 (the reference's ``_attention_scan`` is the same function,
causal from position 0). On a chunked layer the reference's mask (causal
and within one chunk) is causal attention inside each chunk, so prefill
runs the same kernel over the whole chunks as one batch and over the tail
(``_attention``). ``forward``'s attention is ``kernels.autograd``'s
``FlashAttention``: the same kernel forward, and the plain version's
gradient (the kernel has no backward). Decode attends over the cache in
plain torch with the reference's two-pool merge and chunk mask, as the
reference does without a kernel. The MoE is plain torch (``_moe_ffn``), as
the reference computes it outside any kernel.

The cache is updated in place: ``prefill`` writes positions [0, T) and
zeroes the rest, ``decode_step`` writes the new token's k/v at ``cur_pos``.
For finite values that equals the reference's padded copy and one-hot
blend, without copying the cache each step.

Serving (``prefill``, ``decode_step``) runs under ``torch.no_grad`` on
weights that ``init_params`` and ``params_from_jax`` return frozen
(``requires_grad`` off); ``cast_matrices`` drops the float32 masters, so
it is for serving only. Training turns gradients on explicitly
(``params.requires_grad_(True)``) and keeps the float32 masters:
``forward`` runs under autograd and, while grad mode is on, checkpoints
each layer (``torch.utils.checkpoint``, non-reentrant) by
``LMConfig.remat_policy``: "full" keeps only the layer's input, "dots"
also keeps the outputs of its 2-D weight products (``aten.mm``,
``aten.addmm``) and recomputes the rest, attention's batched products
included (the reference's ``dots_with_no_batch_dims_saveable``).

``forward`` returns the logits and the router's aux loss summed over the
MoE layers (float32; 0 on a dense config), and ``loss_fn`` adds
``router_aux_weight`` times it to the cross-entropy, as the reference
does. The backward runs through the capacity dispatch as autograd writes
it: the scatter into the expert batch and the gather back are index
copies, so a dropped token (written to the extra row that is cut off,
and given a zero output row) gets exactly 0 from the routed experts; the
shared expert, the residual and the router's aux loss still reach it.

The reference's bf16 knobs: ``attn_p_bf16`` and ``attn_scores_bf16``
take prefill's and forward's attention through the bf16-score variant of
the kernel (``ops.flash_attention(..., p_bf16=, scores_bf16=)``, with the
reference's rounding points; decode's two-pool attention ignores them, as
the reference's ``_block_decode`` does), and ``logits_bf16`` rounds
``forward``'s tied-embedding logits to bf16 (the loss keeps its float32
logsumexp). ``LMConfig`` has no fields for the reference's XLA lowering
knobs (``kv_block``, ``scan_layers``, ``unroll_kv``; the attention's key
block changes only the rounding).

``param_specs(cfg)`` gives each parameter name the reference's logical
axes (``repro.models.transformer.init_params``'s spec tree) without the
stacked ``"layers"`` axis, for the rules of ``distributed.sharding``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..kernels import autograd, ops
from .layers import (gelu, rms_norm, rope, scalar, silu,
                     softmax_cross_entropy, swiglu)

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
    n_experts: int = 0                # MoE (top-1 with capacity)
    moe_every: int = 1                # MoE on layers with (i+1) % every == 0
    capacity_factor: float = 1.25
    shared_expert: bool = True
    router_aux_weight: float = 0.01
    attn_chunk: int = 0               # 0 -> full attention (llama4 iRoPE)
    global_every: int = 4             # every Nth layer global (NoPE)
    emb_scale: float = 1.0
    resid_scale: float = 1.0
    norm_plus_one: bool = False       # gemma-style (1 + w) RMSNorm
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    vocab_pad: int = 128
    attn_p_bf16: bool = False         # softmax probs in bf16 for P.V
    attn_scores_bf16: bool = False    # whole score pipeline bf16 (m/l fp32)
    logits_bf16: bool = False         # bf16 logits (CE keeps fp32 logsumexp)
    remat_policy: str = "full"        # "full" | "dots" (keep matmul outputs)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + self.vocab_pad - 1)
                // self.vocab_pad) * self.vocab_pad

    def param_count(self) -> int:
        c = self.padded_vocab * self.d_model
        attn = self.d_model * self.hd * (2 * self.n_heads
                                         + 2 * self.n_kv_heads)
        ffn = 3 * self.d_model * self.d_ff
        for i in range(self.n_layers):
            c += attn + 2 * self.d_model
            if self._is_moe(i):
                c += self.n_experts * ffn + self.d_model * self.n_experts
                if self.shared_expert:
                    c += ffn
            else:
                c += ffn
        return c + self.d_model

    def active_param_count(self) -> int:
        c = self.padded_vocab * self.d_model
        attn = self.d_model * self.hd * (2 * self.n_heads
                                         + 2 * self.n_kv_heads)
        ffn = 3 * self.d_model * self.d_ff
        for i in range(self.n_layers):
            c += attn + ffn + 2 * self.d_model   # top-1: one expert active
            if self._is_moe(i) and self.shared_expert:
                c += ffn
        return c + self.d_model

    def _is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i + 1) % self.moe_every == 0


def check_supported(cfg: LMConfig) -> None:
    """Raise ValueError for a setting the model does not know."""
    if cfg.act not in ("silu", "gelu"):
        raise ValueError(f"act must be 'silu' or 'gelu', got {cfg.act!r}")
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError("remat_policy must be 'full' or 'dots', got "
                         f"{cfg.remat_policy!r}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer's weights, named as the reference's ``layers`` keys; a
    MoE layer (``moe``) also holds the router and the experts."""

    def __init__(self, cfg: LMConfig, moe: bool, device=None):
        super().__init__()
        D, H, K, Dh, Fd, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, cfg.d_ff, cfg.n_experts)
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
        self.moe = moe
        if moe:
            self.router = nn.Parameter(torch.empty(D, E, **kw))
            self.e_gate = nn.Parameter(torch.empty(E, D, Fd, **kw))
            self.e_up = nn.Parameter(torch.empty(E, D, Fd, **kw))
            self.e_down = nn.Parameter(torch.empty(E, Fd, D, **kw))


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
        self.layers = nn.ModuleList(Block(cfg, cfg._is_moe(i), device)
                                    for i in range(cfg.n_layers))


_MATRICES = ("wq", "wk", "wv", "wo", "gate", "up", "down")
_EXPERTS = ("router", "e_gate", "e_up", "e_down")


def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights, the reference's scheme: matrices N(0, 1) /
    sqrt(fan_in) in ``param_dtype`` (the fan-in is the second-to-last
    dimension, also of the [E, ...] expert tensors), norms at 1. ``generator`` lives on
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
        for name in _MATRICES + (_EXPERTS if blk.moe else ()):
            p = getattr(blk, name)
            nrm(p, p.shape[-2])       # [..., fan_in, fan_out]
    return model.requires_grad_(False)


def _named_from_tree(cfg: LMConfig, tree) -> Dict[str, np.ndarray]:
    """A tree shaped as the reference's parameters (``embed``,
    ``final_norm`` and ``layers`` of arrays stacked [L, ...]) as arrays
    under the port's parameter names (``layers.<i>.<key>``), in the order
    of ``LM.named_parameters``. A MoE config's expert leaves are taken
    for the MoE layers only; the dense layers' slices go unused."""
    out = {}
    for name, p in LM(cfg, torch.device("meta")).named_parameters():
        if name.startswith("layers."):
            _, i, key = name.split(".")
            a = np.asarray(tree["layers"][key][int(i)])
        else:
            a = np.asarray(tree[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(p.shape)}")
        out[name] = a
    return out


def params_from_jax(cfg: LMConfig, tree, device=None) -> LM:
    """The reference's parameter tree as an ``LM``.

    ``tree`` is ``jax.tree.map(np.asarray, init_params(cfg, key)[0])``:
    ``embed``, ``final_norm`` and ``layers`` of arrays stacked [L, ...].
    Values are copied as they are, so both packages compute on the same
    weights."""
    model = LM(cfg, resolve_device(device)).requires_grad_(False)
    arrays = _named_from_tree(cfg, tree)
    for name, p in model.named_parameters():
        p.copy_(torch.from_numpy(np.array(arrays[name])).to(p.dtype))
    return model


def opt_state_from_jax(cfg: LMConfig, state, device=None):
    """The reference's ``AdamWState`` (numpy leaves: ``step``, and ``m``
    and ``v`` shaped as its parameter tree) as the port's, with ``m`` and
    ``v`` under the parameter names of ``LM``, so that both packages can
    run ``apply_updates`` from one state at any step."""
    from ..train.optimizer import AdamWState
    dev = resolve_device(device)

    def named(tree):
        return {n: torch.from_numpy(np.array(a, np.float32)).to(dev)
                for n, a in _named_from_tree(cfg, tree).items()}

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step, named(state.m), named(state.v))


_SPECS = {
    "embed": ("vocab", "embed"), "final_norm": ("norm",),
    "ln1": ("norm",), "ln2": ("norm",),
    "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
    "gate": ("embed", "mlp"), "up": ("embed", "mlp"),
    "down": ("mlp", "embed"),
    "qnorm": ("head_dim",), "knorm": ("head_dim",),
    # "expert_mlp" (not "mlp"): the model axis already holds the experts
    "router": ("embed", "experts"),
    "e_gate": ("experts", "embed", "expert_mlp"),
    "e_up": ("experts", "embed", "expert_mlp"),
    "e_down": ("experts", "expert_mlp", "embed"),
}


def param_specs(cfg: LMConfig) -> Dict[str, Tuple[str, ...]]:
    """Each parameter name of ``LM(cfg)`` -> its logical axes: the
    reference's spec tree without the leading ``"layers"`` axis of its
    stacked [L, ...] leaves (bound to no mesh axis), since the port keeps
    one tensor a layer."""
    return {name: _SPECS[name.rsplit(".", 1)[-1]]
            for name, _ in LM(cfg, torch.device("meta")).named_parameters()}


def cast_matrices(params: LM, dtype: torch.dtype) -> LM:
    """Store every weight matrix and expert tensor in ``dtype`` (the
    compute dtype), in place; the norm vectors and the router (used in
    float32) stay as they are.

    Every use casts a matrix to the compute dtype first, so a model cast
    this way computes the same values without a cast of all its weights on
    each call (qwen3-1.7b holds 6.9 GB in float32); the float32 masters are
    dropped, so this is for serving."""
    for name, p in params.named_parameters():
        if p.dim() >= 2 and not name.endswith(".router"):
            p.data = p.data.to(dtype)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _dense_ffn(cfg: LMConfig, lw: Block, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, lw.gate.to(x.dtype), lw.up.to(x.dtype),
                  lw.down.to(x.dtype), cfg.act)


class Routing(NamedTuple):
    """Top-1 routing of N tokens over E experts (``route``): each token's
    expert ``eidx`` [N] and gate probability ``gate`` [N] (float32);
    ``order`` [N], the tokens grouped by expert (a stable sort, so a group
    keeps the tokens' order); ``keep`` [N], whether the token at each place
    of ``order`` is among its expert's first ``cap``; ``slot`` [N], its row
    of the [E * cap] expert batch (E * cap where dropped); and the switch
    load-balance loss ``aux``."""
    eidx: torch.Tensor
    gate: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int
    aux: torch.Tensor


def route(cfg: LMConfig, router: torch.Tensor, x2d: torch.Tensor) -> Routing:
    """The reference's routing of x2d [N, D] (``_moe_ffn``): float32 logits
    and softmax, the first largest probability (as ``jnp.argmax``), a
    capacity of max(8, int(capacity_factor * N / E)) tokens an expert, the
    later tokens of a fuller group dropped."""
    N = x2d.shape[0]
    E = cfg.n_experts
    cap = max(8, int(cfg.capacity_factor * N / E))
    logits = x2d.float() @ router.float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)        # jax.nn.softmax's ops
    eidx = probs.argmax(dim=-1)
    gate = probs.gather(1, eidx[:, None])[:, 0]
    frac = torch.nn.functional.one_hot(eidx, E).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    order = torch.argsort(eidx, stable=True)
    se = eidx[order]
    ar = torch.arange(N, device=x2d.device)
    boundary = torch.ones(N, dtype=torch.bool, device=x2d.device)
    boundary[1:] = se[1:] != se[:-1]
    start = torch.cummax(torch.where(boundary, ar, 0), dim=0).values
    pos = ar - start                               # place in its group
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, E * cap)
    return Routing(eidx, gate, order, keep, slot, cap, aux)


def _moe_ffn(cfg: LMConfig, lw: Block,
             x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d [N, D] -> (the routed experts' output [N, D], aux loss): the
    reference's sort-based dispatch. Each expert's first ``cap`` tokens
    fill its rows of an [E, cap, D] batch (rows left over stay 0), the
    expert products run over all E * cap rows, and each kept token's row
    comes back times its gate rounded to the compute dtype; a dropped
    token gets 0."""
    N, D = x2d.shape
    E, dt = cfg.n_experts, x2d.dtype
    r = route(cfg, lw.router, x2d)
    # the extra last row takes the dropped tokens and is cut off (the
    # reference's out-of-range scatter with mode="drop")
    xs = x2d.new_zeros((E * r.cap + 1, D))
    xs[r.slot] = x2d[r.order]
    xs = xs[:-1].reshape(E, r.cap, D)
    h = torch.bmm(xs, lw.e_gate.to(dt))
    u = torch.bmm(xs, lw.e_up.to(dt))
    h = (silu(h) if cfg.act == "silu" else gelu(h)) * u
    ys = torch.bmm(h, lw.e_down.to(dt)).reshape(E * r.cap, D)
    out = x2d.new_zeros((N + 1, D))
    out[torch.where(r.keep, r.order, N)] = (
        ys[torch.clamp_max(r.slot, E * r.cap - 1)] * r.keep[:, None].to(dt))
    return out[:N] * r.gate[:, None].to(dt), r.aux


def _ffn(cfg: LMConfig, lw: Block,
         h2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's FFN on h2 [B, T, D] -> (y, the router's aux loss): the
    dense FFN (aux 0), or on a MoE layer the routed experts over the B * T
    tokens in row-major order plus the shared expert (the layer's
    ``gate``, ``up``, ``down``). Prefill and decode drop the aux loss, as
    the reference's do."""
    if not lw.moe:
        return _dense_ffn(cfg, lw, h2), h2.new_zeros((), dtype=torch.float32)
    h2d = h2.reshape(-1, h2.shape[-1])
    y, aux = _moe_ffn(cfg, lw, h2d)
    if cfg.shared_expert:
        y = y + _dense_ffn(cfg, lw, h2d)
    return y.reshape(h2.shape), aux


def _layer_flags(cfg: LMConfig, i: int) -> Tuple[bool, bool]:
    """(is_global, rope_on) of layer i: without ``attn_chunk`` every layer
    is global with RoPE; with it every ``global_every``-th layer is global
    without RoPE (NoPE) and the others are chunked with RoPE."""
    if not cfg.attn_chunk:
        return True, True
    is_global = (i + 1) % cfg.global_every == 0
    return is_global, not is_global


def _qkv(cfg: LMConfig, lw: Block, x: torch.Tensor, pos: torch.Tensor,
         rope_on: bool):
    """Projections, qk-norm and rope (skipped on a NoPE layer, where the
    reference's ``rope(enabled=False)`` returns its input). x [B, T, D],
    pos [B, T] -> q [B, T, H, Dh], k/v [B, T, K, Dh]."""
    B, T, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lw.ln1, plus_one=cfg.norm_plus_one)
    q = (h @ lw.wq.to(h.dtype)).reshape(B, T, H, Dh)
    k = (h @ lw.wk.to(h.dtype)).reshape(B, T, K, Dh)
    v = (h @ lw.wv.to(h.dtype)).reshape(B, T, K, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lw.qnorm)
        k = rms_norm(k, lw.knorm)
    if not rope_on:
        return q, k, v
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _attention(cfg: LMConfig, impl, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, is_global: bool) -> torch.Tensor:
    """Attention over a prompt from position 0: q [B, T, H, Dh], k/v [B, T,
    K, Dh] -> [B, T, H * Dh], through causal ``impl.flash_attention``.

    A global layer is one call. On a chunked layer the reference's mask
    (causal, both positions in one chunk of C = ``attn_chunk``) is causal
    attention inside each chunk, so the whole chunks run as one call over
    [B * (T // C), H, C, Dh] and the tail as a second over [B, H, T % C,
    Dh]: 1 launch for T <= C, else 1 + (T % C > 0)."""
    B, T, H, Dh = q.shape
    C = cfg.attn_chunk

    def call(q, k, v):
        o = impl.flash_attention(q.transpose(1, 2).contiguous(),
                                 k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(), causal=True,
                                 scores_bf16=cfg.attn_scores_bf16,
                                 p_bf16=cfg.attn_p_bf16)
        return o.transpose(1, 2).reshape(q.shape[0], q.shape[1], H * Dh)

    if is_global or not C or T <= C:
        return call(q, k, v)
    n = T - T % C
    parts = [call(*(t[:, :n].reshape(B * (n // C), C, *t.shape[2:])
                    for t in (q, k, v))).reshape(B, n, H * Dh)]
    if n < T:
        parts.append(call(q[:, n:], k[:, n:], v[:, n:]))
    return torch.cat(parts, dim=1)


def _mlp_residual(cfg: LMConfig, lw: Block, x: torch.Tensor,
                  attn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output projection, residual, FFN, residual. attn [B, T, H*Dh].
    Returns (x, the FFN's router aux loss)."""
    rs = scalar(cfg.resid_scale, x.dtype)
    x = x + rs * (attn @ lw.wo.to(x.dtype))
    h2 = rms_norm(x, lw.ln2, plus_one=cfg.norm_plus_one)
    y, aux = _ffn(cfg, lw, h2)
    return x + rs * y, aux


def _block(cfg: LMConfig, lw: Block, i: int, x: torch.Tensor,
           pos: torch.Tensor, impl=ops):
    """Layer i over a whole prompt from position 0. x [B, T, D].
    Returns (x, k, v, aux) with k/v [B, T, K, Dh] and the layer's router
    aux loss (float32, 0 on a dense layer)."""
    is_global, rope_on = _layer_flags(cfg, i)
    q, k, v = _qkv(cfg, lw, x, pos, rope_on)
    attn = _attention(cfg, impl, q, k, v, is_global)
    x, aux = _mlp_residual(cfg, lw, x, attn)
    return x, k, v, aux


def _block_decode(cfg: LMConfig, lw: Block, i: int, x: torch.Tensor,
                  pos_q: torch.Tensor, pos_k: torch.Tensor,
                  kc: torch.Tensor, vc: torch.Tensor):
    """Layer i for one new token per lane. x [B, 1, D], pos_q [B, 1],
    pos_k [S], kc/vc [B, S, K, Dh] (the cache before this step).

    Attention is the reference's two-pool merge in float32: the cache's
    strictly earlier positions (on a chunked layer only those in the new
    token's chunk) and the new token itself, combined through one max.
    Returns (x, k, v) with the new token's k/v [B, 1, K, Dh]."""
    B, T, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    is_global, rope_on = _layer_flags(cfg, i)
    q, kn, vn = _qkv(cfg, lw, x, pos_q, rope_on)
    mask_prev = pos_k[None, :] < pos_q
    if not is_global:
        C = cfg.attn_chunk
        mask_prev = mask_prev & (pos_k[None, :] // C == pos_q // C)
    mask_prev = mask_prev[:, None, None, None, :]
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
    return _mlp_residual(cfg, lw, x, attn)[0], kn, vn


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _embed(cfg: LMConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    return (params.embed[tokens.long()].to(cfg.dtype)
            * scalar(cfg.emb_scale, cfg.dtype))


def _logits(cfg: LMConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, plus_one=cfg.norm_plus_one)
    return x @ params.embed.to(x.dtype).T


# the 2-D weight products: what remat_policy "dots" keeps for backward.
# The MoE's expert products are batched (``bmm`` over [E, cap, D]), so
# they are recomputed, as the reference's dots_with_no_batch_dims_saveable
# saves no product with a batch dimension.
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _layer(cfg: LMConfig, lw: Block, i: int, x: torch.Tensor,
           pos: torch.Tensor, impl, remat: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training layer i: ``_block``'s (x, aux), checkpointed by
    ``cfg.remat_policy`` when ``remat`` is set and grad mode is on. The
    recompute routes the recomputed input again: the same ops on the same
    input give the same routing."""
    def run(x):
        x, _, _, aux = _block(cfg, lw, i, x, pos, impl)
        return x, aux
    if not (remat and torch.is_grad_enabled()):
        return run(x)
    if cfg.remat_policy == "dots":
        return checkpoint(run, x, use_reentrant=False, context_fn=(
            functools.partial(create_selective_checkpoint_contexts, _DOTS)))
    return checkpoint(run, x, use_reentrant=False)


def forward(cfg: LMConfig, params: LM, tokens: torch.Tensor,
            remat: bool = True,
            impl=autograd) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forcing forward. tokens int [B, T] -> (logits [B, T, V] in
    the compute dtype, the router aux loss): the aux loss is the float32
    sum of the MoE layers' ``route(...).aux``, 0 on a dense config.

    Runs under autograd: with grad mode on and ``remat`` set, each layer
    is checkpointed by ``cfg.remat_policy``. ``impl`` supplies
    ``flash_attention``: ``kernels.autograd`` (the default: the kernel
    forward, the plain version's gradient) or ``kernels.ref`` (the plain
    version under autograd, on either device)."""
    check_supported(cfg)
    B, T = tokens.shape
    x = _embed(cfg, params, tokens)
    pos = torch.arange(T, device=x.device).expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lw in enumerate(params.layers):
        x, a = _layer(cfg, lw, i, x, pos, impl, remat)
        aux = aux + a
    logits = _logits(cfg, params, x)
    if cfg.logits_bf16:
        logits = logits.to(torch.bfloat16)
    return logits, aux


def loss_fn(cfg: LMConfig, params: LM, batch,
            impl=autograd) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of ``batch["tokens"]`` int [B, T + 1] (numpy or a
    tensor; moved to the parameters' device), with an optional
    ``batch["loss_mask"]`` [B, T + 1]: the float32 cross-entropy of
    ``forward`` over ``tokens[:, :-1]`` against ``tokens[:, 1:]``, the
    logits cut to ``cfg.vocab`` (the padded rows never win). Returns
    ``(ce + router_aux_weight * aux, {"ce", "router_aux"})``; a dense
    config's router aux loss is 0."""
    dev = params.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    logits, aux = forward(cfg, params, tokens[:, :-1], impl=impl)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)[:, 1:]
    ce = softmax_cross_entropy(logits[..., :cfg.vocab], tokens[:, 1:], mask)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "router_aux": aux}


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
        x, k, v, _ = _block(cfg, lw, i, x, pos, impl)
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
        x, k, v = _block_decode(cfg, lw, i, x, pos_q, pos_k, cache["k"][i],
                                cache["v"][i])
        ks.append(k[:, 0])
        vs.append(v[:, 0])
    lanes = torch.arange(x.shape[0], device=x.device)
    cache["k"][:, lanes, cur] = torch.stack(ks)
    cache["v"][:, lanes, cur] = torch.stack(vs)
    return _logits(cfg, params, x)[:, 0], cache
