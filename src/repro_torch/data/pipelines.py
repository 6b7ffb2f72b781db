"""Host-side batch generators (counterpart of ``repro.data.pipelines``):
the LM token stream.

Deterministic per (seed, step), so a restarted job resumes the same data
order: every batch comes from ``default_rng((seed, step))`` with no
sequential RNG state. numpy only, as in the reference, which gives the
same arrays bit for bit.
"""
from __future__ import annotations

from typing import Dict

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
