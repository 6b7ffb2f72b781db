"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function has the signature of its wrapper in ``kernels/ops.py``. The
wrappers call these for tensors on the CPU; ``chip_smoke.py`` holds each
CUDA kernel against its plain version on the card, and the exact scan can
run through this module (``impl=ref``) to compare a whole route.
"""
from __future__ import annotations

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
