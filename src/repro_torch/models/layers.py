"""Shared layers of the LM (counterpart of ``repro.models.layers``).

The reference runs under XLA, which rounds every op of a bf16 expression
to bf16 and rounds a Python scalar to the array's dtype before using it.
Eager torch rounds each op's result too, but computes ``x * c`` with ``c``
at float32. ``scalar`` rounds a constant to the dtype first, and ``silu``
and ``gelu`` are written op by op as ``jax.nn`` writes them, so that in
bf16 they give the reference's values bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as a weakly typed JAX scalar is."""
    return float(torch.tensor(c, dtype=dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * (1 / (1 + exp(-x))), each op in x's dtype."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form), each op in x's dtype."""
    inner = x + scalar(0.044715, x.dtype) * (x * x * x)
    t = torch.tanh(scalar(math.sqrt(2.0 / math.pi), x.dtype) * inner)
    return x * (scalar(0.5, x.dtype) * (1.0 + t))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to x's dtype; the scale is
    ``1 + w`` when ``plus_one`` (gemma), else ``w``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (x * scale).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding in the half-split form (not interleaved).

    x [..., T, H, D], pos int [..., T]. The angles are float32; the
    rotation runs in float32 (x's halves promote) and is cast back."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = (pos[..., None].float() * freqs)[..., None, :]   # [..., T, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    rx = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rx.to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Token cross-entropy in float32: the mean over tokens, or with
    ``mask`` the masked sum over ``max(sum(mask), 1)``. logits [..., V] in
    any float dtype, labels int [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(loss * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(loss)
