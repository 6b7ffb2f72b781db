"""Host-side batch generators (counterpart of ``repro.data.pipelines``):
the LM token stream and the recsys CTR batches.

Deterministic per (seed, step), so a restarted job resumes the same data
order: every batch comes from ``default_rng((seed, step))`` with no
sequential RNG state. numpy only, as in the reference, which gives the
same arrays bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def lm_batch(step: int, batch: int, seq: int, vocab: int,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic LM tokens: Zipf-ish marginals + local repetition structure
    so the loss has learnable signal. tokens int32 [B, seq+1]."""
    rng = np.random.default_rng((seed, step))
    z = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    tokens = (z % (vocab - 2)) + 1
    # inject copy structure: second half repeats first half shifted
    half = (seq + 1) // 2
    tokens[:, half:half * 2] = tokens[:, :half]
    return {"tokens": tokens.astype(np.int32)}


def recsys_batch(step: int, batch: int, n_sparse: int,
                 vocabs: Tuple[int, ...], n_dense: int = 13,
                 seed: int = 0, kind: str = "fm",
                 seq_len: int = 100) -> Dict[str, np.ndarray]:
    """Synthetic CTR batch with a planted logistic teacher signal: for
    ``kind="din"`` a target id, a behaviour history of ``seq_len`` ids
    (global rows of the fused table) and its mask; otherwise per-field
    local ids [B, n_sparse], dense features [B, n_dense] and the label."""
    rng = np.random.default_rng((seed, step))
    if kind == "din":
        total = sum(vocabs)
        target = rng.integers(0, total, batch).astype(np.int32)
        hist = rng.integers(0, total, (batch, seq_len)).astype(np.int32)
        # clicks correlate with history/target id parity overlap
        y = ((target % 7 == (hist % 7).mean(1).round()).astype(np.float32))
        return {"target_id": target, "hist_ids": hist,
                "hist_mask": np.ones((batch, seq_len), bool),
                "label": y}
    ids = np.stack([rng.integers(0, v, batch) for v in vocabs[:n_sparse]],
                   axis=1).astype(np.int32)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    logit = ((dense[:, 0] * 0.5 if n_dense else 0.0)
             + ((ids[:, 0] % 5) - 2) * 0.3)
    y = (rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"sparse_ids": ids, "dense": dense, "label": y}
