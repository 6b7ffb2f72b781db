"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function has the signature of its wrapper in ``kernels/ops.py``. The
wrappers call these for tensors on the CPU; ``chip_smoke.py`` holds each
CUDA kernel against its plain version on the card, and the exact scan can
run through this module (``impl=ref``) to compare a whole route, as can
the LM's prefill (``models.transformer.prefill(..., impl=ref)``).
"""
from __future__ import annotations

import math

import torch

from ..core.distances import gathered_dot
from ..core.filters import popc32


def fused_expand(packed: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                 q_norm: torch.Tensor, *, d: int):
    """One row gather over packed f32 [N, d+1+A] rows of [vec | sq-norm |
    attr words]; ids int[B, C] (clamped into range), q f32 [B, d], q_norm
    f32 [B] -> (d2 f32 [B, C], attr words f32 [B, C, A], bits as stored).

    The dot goes through ``gathered_dot``, so the fused route's keys equal
    the default route's bit for bit inside torch.
    """
    rows = packed[ids.clamp(0, packed.shape[0] - 1)]
    dots = gathered_dot(rows[..., :d], q)
    d2 = torch.clamp_min(rows[..., d] - 2.0 * dots + q_norm[:, None], 0.0)
    return d2, rows[..., d + 1:]


def gather_dist_tile(xb: torch.Tensor, base: torch.Tensor, q: torch.Tensor,
                     *, tile: int) -> torch.Tensor:
    """Lane b scores rows [base[b]*tile, (base[b]+1)*tile) of xb f32
    [N_pad, d_pad] against q[b] -> f32 [B, tile], squared L2 clamped at 0.

    ``base`` is clamped into [0, N_pad / tile). The sums run over d in
    order with a rounded multiply then a rounded add per term, the exact
    arithmetic of the CUDA kernel, so the two agree bit for bit.
    """
    n_tiles = xb.shape[0] // tile
    rows = (base.to(torch.int64).clamp(0, n_tiles - 1)[:, None] * tile
            + torch.arange(tile, device=xb.device))            # [B, tile]
    if bool((base == base[0]).all()):
        x = xb[rows[0]][None]                                  # [1, tile, d]
    else:
        x = xb[rows]                                           # [B, tile, d]
    B, dp = q.shape
    dot = torch.zeros((B, tile), dtype=torch.float32, device=xb.device)
    xn = torch.zeros(x.shape[:2], dtype=torch.float32, device=xb.device)
    qn = torch.zeros((B,), dtype=torch.float32, device=xb.device)
    for k in range(dp):
        xk = x[..., k]
        dot = dot + q[:, k:k + 1] * xk
        xn = xn + xk * xk
        qn = qn + q[:, k] * q[:, k]
    return torch.clamp_min(xn - 2.0 * dot + qn[:, None], 0.0)


def bitset_dist(a: torch.Tensor, b: torch.Tensor, *, op: str = "xor",
                chunk: int = 32) -> torch.Tensor:
    """Bitset distance matrix: a int32 [B, W], b int32 [N, W] words ->
    int32 [B, N]. op="xor": Hamming; op="deficit": popcount(a & ~b)."""
    if op not in ("xor", "deficit"):
        raise ValueError(f"op must be 'xor' or 'deficit', got {op!r}")
    B, W = a.shape
    out = torch.zeros((B, b.shape[0]), dtype=torch.int32, device=a.device)
    for w0 in range(0, W, chunk):
        aw = a[:, None, w0:w0 + chunk]
        bw = b[None, :, w0:w0 + chunk]
        x = (aw ^ bw) if op == "xor" else (aw & ~bw)
        out += torch.sum(popc32(x), dim=-1, dtype=torch.int32)
    return out


def subset_deficit(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """|f \\ a| matrix [B, N] (subset dist_F)."""
    return bitset_dist(f, a, op="deficit")


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed Hamming distance matrix [B, N]."""
    return bitset_dist(a, b, op="xor")


def gather_dist(xb: torch.Tensor, ids: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Row gather then squared L2 in the difference form: xb [N, d] (f32 or
    bf16, read as f32), ids int[B, C] (clamped into [0, N)), q [B, d] ->
    f32 [B, C] = sum_k (xb[ids[b, c], k] - q[b, k])^2, not clamped."""
    rows = xb[ids.long().clamp(0, xb.shape[0] - 1)].float()
    diff = rows - q.float()[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def l2dist(q: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix: q [B, d], xb [N, d] (f32 or bf16, read
    as f32) -> f32 [B, N] = max(|q|^2 + |x|^2 - 2 q.x, 0)."""
    q = q.float()
    xb = xb.float()
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    xn = torch.sum(xb * xb, dim=-1)
    return torch.clamp_min(qn + xn[None, :] - 2.0 * (q @ xb.T), 0.0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scores_bf16: bool = False,
                    p_bf16: bool = False) -> torch.Tensor:
    """Online-softmax attention with the TPU kernel's arithmetic.

    q [B, H, Tq, D], k/v [B, Hkv, Tk, D] (H a multiple of Hkv; query head h
    reads kv head h // (H / Hkv)), any float dtype -> q's dtype. Everything
    runs in float32: q is scaled by 1/sqrt(D) before the product, keys come
    in blocks of the bf16 kernel's key tile (128 keys, 64 at D > 128) with
    a running max and sum, the causal mask is ``row >= col`` and the same
    -inf guards keep fully masked rows at 0. Causal attention needs Tq ==
    Tk (the mask has no offset).

    The LM's bf16 score knobs follow the reference's rounding points
    (``repro.models.transformer._attention_scan``), on bf16 copies of the
    inputs. ``p_bf16``: S and p in float32, l sums the float32 p, and P.V
    takes bf16(p) with float32 accumulation. ``scores_bf16``: q is divided
    by bf16(sqrt(D)) in bf16, S is accumulated in float32 and rounded to
    bf16, m stays float32, p = exp(s - bf16(m_safe)) in bf16 (each op
    rounded), l sums the bf16 p in float32 and P.V takes p as it is. The
    reference rounds p against the running max of its ``kv_block`` blocks;
    here against that of the key blocks above, as the kernel does. A
    knobbed call's output is rounded to bf16, then cast to q's dtype (the
    reference keeps a float32 model's output in float32; the knobs serve
    bf16 models).
    """
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    if causal and Tq != Tk:
        raise ValueError(f"causal attention needs Tq == Tk, got {Tq}, {Tk}")
    G = H // Hkv
    block_k = 128 if D <= 128 else 64
    bf16 = torch.bfloat16
    knobbed = scores_bf16 or p_bf16
    if knobbed:
        k, v = k.to(bf16), v.to(bf16)
    if scores_bf16:
        qs = q.to(bf16) / torch.tensor(math.sqrt(D), dtype=bf16)
        qf = qs.float().reshape(B, Hkv, G * Tq, D)
    else:
        qin = q.to(bf16) if knobbed else q
        qf = (qin.float() * (1.0 / math.sqrt(D))).reshape(B, Hkv, G * Tq, D)
    rows = torch.arange(Tq, device=q.device).repeat(G)[:, None]
    m = torch.full((B, Hkv, G * Tq, 1), -math.inf, device=q.device)
    l = torch.zeros((B, Hkv, G * Tq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G * Tq, D), device=q.device)
    for k0 in range(0, Tk, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        s = qf @ kb.transpose(-1, -2)                 # [B, Hkv, G*Tq, bk]
        if scores_bf16:
            s = s.to(bf16)
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = torch.where(rows >= cols[None, :], s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True).float())
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe.to(s.dtype))
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + torch.sum(p.float(), dim=-1, keepdim=True)
        pv = p.to(bf16).float() if knobbed else p
        acc = acc * corr + pv @ vb
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    if knobbed:             # the bf16 copies' output, as the kernel writes
        out = out.to(bf16)
    return out.reshape(B, H, Tq, D).to(q.dtype)
