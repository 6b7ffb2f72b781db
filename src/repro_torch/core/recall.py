"""Recall / QPS / distance-computation measurement (counterpart of
``repro.core.recall``).

recall@k follows the filtered-ANN convention of the paper's figures: for
each query, |returned ∩ exact-top-k| / |exact-top-k|, where exact-top-k holds
only filter-satisfying points (may be < k at low selectivity) and returned
results count only where they satisfy the filter (primary key == 0).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .ground_truth import GroundTruth


class EvalResult(NamedTuple):
    recall: float
    qps: float
    mean_dist_comps: float
    per_query_recall: np.ndarray


def recall_at_k(result_ids: np.ndarray, result_valid: np.ndarray,
                gt_ids: np.ndarray) -> np.ndarray:
    """Per-query recall. gt_ids padded with -1; result_valid masks
    non-matching returned points (e.g. primary > 0)."""
    B = gt_ids.shape[0]
    out = np.ones((B,), np.float64)
    for b in range(B):
        gt = set(int(i) for i in gt_ids[b] if i >= 0)
        if not gt:
            continue  # vacuous query: recall 1 by convention
        got = set(int(i) for i, v in zip(result_ids[b], result_valid[b]) if v)
        out[b] = len(gt & got) / len(gt)
    return out


def _wait(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def evaluate(search_fn: Callable[[], "SearchResult"], gt: GroundTruth,
             timed_repeats: int = 3) -> EvalResult:
    """Run a zero-arg search closure once to warm up, then time it; the
    clock stops only after the device has finished."""
    res = search_fn()
    _wait(res.ids)
    t0 = time.perf_counter()
    for _ in range(timed_repeats):
        res = search_fn()
        _wait(res.ids)
    dt = (time.perf_counter() - t0) / timed_repeats
    ids = res.ids.cpu().numpy()
    valid = res.primary.cpu().numpy() == 0.0
    pq = recall_at_k(ids, valid, gt.ids.cpu().numpy())
    nd = (float(res.n_dist.to(torch.float64).mean()) if hasattr(res, "n_dist")
          else 0.0)
    return EvalResult(float(pq.mean()), ids.shape[0] / dt, nd, pq)
