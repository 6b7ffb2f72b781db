"""Subset filters (MSTuring tag subsets, JAG paper App. D.2): every row
holds ``n_attrs`` Bernoulli(1/2) tags; a query requires k of them and
matches the rows that hold all k.

Configuration keys: ``n``, ``d``, ``n_attrs``. Traffic keys:
``required_bits`` (the k of each batch, evenly filled), ``batch``,
``pool``.
"""
from __future__ import annotations

import numpy as np
import torch

from jagbench import datagen


def generate(cfg: dict, traffic: dict, seed: int) -> dict:
    """The cell's rows and its pool of query batches, from ``seed``."""
    b = traffic["batch"] * traffic["pool"]
    xb, bits, q, fbits = datagen.msturing_subset(
        n=cfg["n"], d=cfg["d"], b=b, n_attrs=cfg["n_attrs"], seed=seed,
        req_ks=tuple(traffic["required_bits"]),
        balanced_batch=traffic["batch"])
    return dict(xb=xb, rows=datagen.pack_u32(bits), queries=q,
                filters=datagen.pack_u32(fbits))


def attr_words(cfg: dict) -> int:
    return (cfg["n_attrs"] + 31) // 32


# -- the program's side: its table and filters, from the same raw words ----

def program_table(data: dict, cfg: dict, device):
    from repro_torch.core.filters import subset_table
    return subset_table(data["rows"], cfg["n_attrs"], device=device)


def program_filters(words: np.ndarray, cfg: dict, device):
    from repro_torch.core.filters import subset_filters
    return subset_filters(words, cfg["n_attrs"], device=device)


# -- the reference's side -------------------------------------------------

def ref_rows(data: dict, device) -> torch.Tensor:
    """Row words as int64 [N, W] (uint32 values, never negative)."""
    return torch.as_tensor(data["rows"].astype(np.int64), device=device)


def ref_queries(words: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(words.astype(np.int64), device=device)


def ref_match(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bool [B, M]: query b's required tags all held by row m; ``rows`` is
    [M, W] (every query against every row) or [B, M, W] (rows a query)."""
    if rows.dim() == 2:
        rows = rows.unsqueeze(0)
    qq = q.unsqueeze(1)
    return ((rows & qq) == qq).all(dim=-1)
