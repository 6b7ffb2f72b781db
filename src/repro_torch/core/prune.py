"""JointRobustPrune (Algorithm 4), batched over B insertion lanes
(counterpart of ``repro.core.prune``).

For each threshold ``t`` (or weight ``w``) bucket, candidates are sorted by
the bucket comparator and admitted by an α-RobustPrune scan: candidate v
survives iff no previously admitted u has ``α²·d2(u, v) < d2(p, v)``. A
candidate admitted by an earlier bucket rides into the current bucket
without consuming a new edge; ``fill`` is the overflow re-prune's early-exit
factor (paper D.3).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .distances import INF, capped, lex_sort


def _bucket_order(prim: torch.Tensor, sec: torch.Tensor) -> torch.Tensor:
    """Permutation sorting candidates by (prim, sec) lexicographically."""
    idx = torch.arange(prim.shape[-1], device=prim.device).expand_as(prim)
    return lex_sort(prim, sec, idx)[2]


def joint_robust_prune(cand_valid: torch.Tensor,   # bool [B, C]
                       d2_p: torch.Tensor,         # f32 [B, C]
                       da_p: torch.Tensor,         # f32 [B, C]
                       pair_d2: torch.Tensor,      # f32 [B, C, C]
                       *,
                       degree: int,
                       alpha: float,
                       thresholds: Sequence[float] | None = None,
                       weights: Sequence[float] | None = None,
                       fill: float = 1.0) -> torch.Tensor:
    """Returns bool[B, C]: which candidates become out-neighbours
    (<= degree)."""
    if (thresholds is None) == (weights is None):
        raise ValueError("give exactly one of thresholds / weights")
    buckets = thresholds if thresholds is not None else weights
    cap = max(1, int(fill * degree / len(buckets)))
    B, C = d2_p.shape
    dev = d2_p.device
    alpha2 = torch.tensor(alpha, dtype=torch.float32) ** 2
    rows = torch.arange(B, device=dev)

    d2_masked = torch.where(cand_valid, d2_p, INF)
    selected = torch.zeros((B, C), dtype=torch.bool, device=dev)
    for bval in buckets:
        bval = torch.tensor(bval, dtype=torch.float32)
        if thresholds is not None:
            prim = capped(da_p, bval.to(dev))
        else:
            prim = bval.to(dev) * da_p + torch.sqrt(d2_masked)
        prim = torch.where(cand_valid, prim, INF)
        perm = _bucket_order(prim, d2_masked)                 # [B, C]
        dominated = torch.zeros((B, C), dtype=torch.bool, device=dev)
        count = torch.zeros((B,), dtype=torch.int32, device=dev)
        for j in range(C):
            cidx = perm[:, j]
            ok = cand_valid[rows, cidx] & ~dominated[rows, cidx] & (count < cap)
            selected[rows, cidx] |= ok
            # v_j dominates w iff alpha^2 * d2(v_j, w) < d2(p, w)
            dom_j = (alpha2 * pair_d2[rows, cidx]) < d2_masked
            dominated |= ok[:, None] & dom_j
            count += ok.to(torch.int32)
    return selected


def select_to_rows(selected: torch.Tensor, cand_ids: torch.Tensor,
                   d2_p: torch.Tensor, degree: int) -> torch.Tensor:
    """Compact a selection mask into id rows [B, degree], -1 padded,
    survivors ordered by vector distance."""
    key = torch.where(selected, d2_p, INF)
    ids = torch.where(selected, cand_ids, -1)
    return lex_sort(key, None, ids)[1][:, :degree]
