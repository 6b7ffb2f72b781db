"""Label filters (SIFT with labels, JAG paper App. D.2): every row holds
one of ``n_labels`` uniform labels; a query asks for one label and matches
the rows that hold it.

Configuration keys: ``n``, ``d``, ``n_labels``. Traffic keys: ``batch``,
``pool`` (labels evenly filled in every batch).
"""
from __future__ import annotations

import numpy as np
import torch

from jagbench import datagen


def generate(cfg: dict, traffic: dict, seed: int) -> dict:
    """The cell's rows and its pool of query batches, from ``seed``."""
    b = traffic["batch"] * traffic["pool"]
    xb, labels, q, qlab = datagen.sift_like(
        n=cfg["n"], d=cfg["d"], b=b, n_labels=cfg["n_labels"], seed=seed,
        balanced_batch=traffic["batch"])
    return dict(xb=xb, rows=labels.astype(np.int32), queries=q,
                filters=qlab.astype(np.int32))


def attr_words(cfg: dict) -> int:
    return 1


# -- the program's side: its table and filters, from the same raw labels ---

def program_table(data: dict, cfg: dict, device):
    from repro_torch.core.filters import label_table
    return label_table(data["rows"], device=device)


def program_filters(labels: np.ndarray, cfg: dict, device):
    from repro_torch.core.filters import label_filters
    return label_filters(labels, device=device)


# -- the reference's side -------------------------------------------------

def ref_rows(data: dict, device) -> torch.Tensor:
    return torch.as_tensor(data["rows"].astype(np.int64), device=device)


def ref_queries(labels: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(labels.astype(np.int64), device=device)


def ref_match(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bool [B, M]: row m holds query b's label; ``rows`` is [M] (every
    query against every row) or [B, M] (rows a query)."""
    if rows.dim() == 1:
        rows = rows.unsqueeze(0)
    return rows == q.unsqueeze(1)
