"""Shared layers (counterpart of ``repro.models.layers``): the LM's norms,
rope, activations, gated MLP (``swiglu``) and loss, and the recsys
models' MLP towers (``Dense``, ``mlp_stack``, ``mlp_apply``).

The reference runs under XLA, which rounds every op of a bf16 expression
to bf16 and rounds a Python scalar to the array's dtype before using it.
Eager torch rounds each op's result too, but computes ``x * c`` with ``c``
at float32. ``scalar`` rounds a constant to the dtype first, and ``silu``
and ``gelu`` are written op by op as ``jax.nn`` writes them, so that in
bf16 they give the reference's values bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn


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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP. x [..., d]; w_gate/w_up [d, f]; w_down [f, d]; ``act``
    "silu" or "gelu" (GeGLU, tanh form)."""
    g = x @ w_gate
    u = x @ w_up
    if act == "silu":
        g = silu(g)
    elif act == "gelu":
        g = gelu(g)
    else:
        raise ValueError(act)
    return (g * u) @ w_down


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


def dense(generator: torch.Generator, in_dim: int, out_dim: int,
          dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """A dense kernel [in_dim, out_dim] drawn as the reference draws it:
    N(0, 1) / sqrt(in_dim) (LeCun normal). ``generator`` lives on
    ``device`` (the numbers differ from jax.random's)."""
    return torch.randn((in_dim, out_dim), generator=generator, dtype=dtype,
                       device=device) / math.sqrt(in_dim)


class Dense(nn.Module):
    """One layer of an MLP tower: ``w`` [in, out] and ``b`` [out] (the
    reference's ``{"w", "b"}``), both empty until drawn or copied."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, dtype=dtype,
                                          device=device))
        self.b = nn.Parameter(torch.zeros(out_dim, dtype=dtype,
                                          device=device))


def mlp_stack(dims: Sequence[int], generator: Optional[torch.Generator],
              dtype: torch.dtype = torch.float32,
              device=None) -> nn.ModuleList:
    """A plain MLP tower over ``dims`` (``len(dims) - 1`` ``Dense``
    layers): kernels from ``dense``, biases 0. Without a generator the
    kernels stay empty (for ``copy_from_tree`` or the meta device)."""
    tower = nn.ModuleList(Dense(dims[i], dims[i + 1], dtype, device)
                          for i in range(len(dims) - 1))
    if generator is not None:
        with torch.no_grad():
            for layer in tower:
                layer.w.copy_(dense(generator, *layer.w.shape, dtype=dtype,
                                    device=device))
    return tower


def mlp_apply(tower: nn.ModuleList, x: torch.Tensor,
              final_act: bool = False) -> torch.Tensor:
    """x @ w + b through the tower, relu between layers (and after the
    last with ``final_act``); x promotes to the kernels' dtype first, as
    JAX promotes a bf16 input against float32 weights."""
    for i, layer in enumerate(tower):
        x = x.to(torch.promote_types(x.dtype, layer.w.dtype)) @ layer.w \
            + layer.b
        if i < len(tower) - 1 or final_act:
            x = torch.relu(x)
    return x


def copy_from_tree(module: nn.Module, tree) -> nn.Module:
    """Copy a reference parameter tree (nested dicts and lists of numpy
    arrays) into ``module``'s parameters by name: ``mlp.0.w`` is
    ``tree["mlp"][0]["w"]``. Shapes must agree; values keep their bits,
    cast to each parameter's dtype. Returns the module, frozen
    (``requires_grad`` off)."""
    import numpy as np
    module.requires_grad_(False)
    for name, p in module.named_parameters():
        a = tree
        for key in name.split("."):
            a = a[int(key)] if isinstance(a, (list, tuple)) else a[key]
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))
    return module


def batch_to(device: torch.device, batch: Mapping) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors, each moved to ``device`` (the
    parameters' device)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
