"""Synthetic filtered-ANN datasets at the paper's structural parameters
(App. D.2); the port's own copy of ``repro.data.synthetic``'s generators.

The draws are the reference's, from numpy's generator in the same order,
so both packages produce the same vectors, attributes and filters for a
seed; the tables and filters are then placed on ``device`` (default
"cuda").

  sift_like       - label filter: uniform label in {0..11}; query = a label.
  msturing_subset - 30 Bernoulli(1/2) attributes; a query requires k of them
                    (k from ``req_ks``: selectivity 1 .. 2^-12 by default).
  msturing_bool   - random boolean predicates over 15 variables with pass
                    rates in (2^-4,1), (2^-8,2^-4), (2^-12,2^-8), (0,2^-12).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import filters as F


@dataclasses.dataclass
class FilteredDataset:
    name: str
    xb: np.ndarray                 # [N, d] float32
    attr: F.AttrTable
    queries: np.ndarray            # [B, d] float32
    filt: F.FilterBatch
    selectivity: np.ndarray        # [B] empirical selectivity per query


def _clustered(rng, n, d, n_clusters=32, spread=1.0, scale=4.0):
    centers = rng.normal(size=(n_clusters, d)) * scale
    asg = rng.integers(0, n_clusters, n)
    x = centers[asg] + rng.normal(size=(n, d)) * spread
    return x.astype(np.float32), centers, asg


def _queries(rng, centers, b, d, spread=1.0):
    asg = rng.integers(0, centers.shape[0], b)
    return (centers[asg] + rng.normal(size=(b, d)) * spread).astype(
        np.float32), asg


def _pack_u32(bits: np.ndarray) -> np.ndarray:
    """bool [M, L] -> little-endian uint32 words [M, ceil(L/32)]."""
    b = np.packbits(bits, axis=1, bitorder="little")
    b = np.pad(b, ((0, 0), (0, (-b.shape[1]) % 4)))
    return np.ascontiguousarray(b).view("<u4")


def sift_like(n=20000, d=64, b=256, n_labels=12, seed=0,
              device=None) -> FilteredDataset:
    rng = np.random.default_rng(seed)
    xb, centers, _ = _clustered(rng, n, d)
    q, _ = _queries(rng, centers, b, d)
    labels = rng.integers(0, n_labels, n)
    qlab = rng.integers(0, n_labels, b)
    counts = np.bincount(labels, minlength=n_labels)
    sel = counts[qlab] / n
    return FilteredDataset("sift_like", xb, F.label_table(labels, device), q,
                           F.label_filters(qlab, device), sel)


def msturing_subset(n=20000, d=64, b=256, n_attrs=30, seed=0,
                    req_ks=(0, 2, 4, 6, 8, 10, 12),
                    device=None) -> FilteredDataset:
    rng = np.random.default_rng(seed)
    xb, centers, _ = _clustered(rng, n, d)
    q, _ = _queries(rng, centers, b, d)
    bits = rng.random((n, n_attrs)) < 0.5
    k = rng.choice(req_ks, b)
    fbits = np.zeros((b, n_attrs), bool)
    for i in range(b):
        fbits[i, rng.choice(n_attrs, k[i], replace=False)] = True
    # selectivity from packed 32-bit words: the fraction of rows holding
    # every required bit (the reference counts the same rows bit by bit)
    words, fwords = (_pack_u32(x) for x in (bits, fbits))
    sel = np.array([np.all((words & f) == f, axis=1).mean() for f in fwords])
    return FilteredDataset("msturing_subset", xb,
                           F.subset_table(bits, n_attrs, device=device), q,
                           F.subset_filters(fbits, n_attrs, device=device),
                           sel)


def msturing_bool(n=20000, d=64, b=128, n_vars=15, seed=0,
                  device=None) -> FilteredDataset:
    rng = np.random.default_rng(seed)
    xb, centers, _ = _clustered(rng, n, d)
    q, _ = _queries(rng, centers, b, d)
    assign = rng.integers(0, 1 << n_vars, n).astype(np.uint32)
    bands = [(2.0 ** -4, 1.0), (2.0 ** -8, 2.0 ** -4),
             (2.0 ** -12, 2.0 ** -8), (2.0 ** -15, 2.0 ** -12)]
    size = 1 << n_vars
    sat = np.zeros((b, size), bool)
    for i in range(b):
        lo, hi = bands[rng.integers(0, len(bands))]
        rate = np.exp(rng.uniform(np.log(max(lo, 2.0 ** -15)), np.log(hi)))
        sat[i] = rng.random(size) < rate
        if not sat[i].any():
            sat[i, rng.integers(0, size)] = True
    sel = sat[:, assign.astype(np.int64)].mean(axis=1)
    return FilteredDataset("msturing_bool", xb,
                           F.boolean_table(assign, n_vars, device=device), q,
                           F.boolean_filters(sat, n_vars, device=device), sel)

