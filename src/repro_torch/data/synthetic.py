"""Synthetic filtered-ANN datasets at the paper's structural parameters
(App. D.2); the port's own copy of ``repro.data.synthetic``'s generators.

The draws are the reference's, from numpy's generator in the same order,
so both packages produce the same vectors, attributes and filters for a
seed; the tables and filters are then placed on ``device`` (default
"cuda").

  sift_like       - label filter: uniform label in {0..11}; query = a label.
  msturing_range  - integer attribute in [0, 1e6]; query ranges of length
                    1e6/k, k in {1,10,1e2,1e3,1e4,1e5} (mixed selectivity).
  msturing_subset - 30 Bernoulli(1/2) attributes; a query requires k of them
                    (k from ``req_ks``: selectivity 1 .. 2^-12 by default).
  msturing_bool   - random boolean predicates over 15 variables with pass
                    rates in (2^-4,1), (2^-8,2^-4), (2^-12,2^-8), (0,2^-12).
  laion_like      - 30 keyword clusters; each point tagged with its 3
                    nearest keyword centres (subset filter; the query's
                    keyword is positive, random or negative to its vector).
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


def msturing_range(n=20000, d=64, b=256, seed=0,
                   sel_ks=(1, 10, 100, 1000, 10_000, 100_000),
                   device=None) -> FilteredDataset:
    rng = np.random.default_rng(seed)
    xb, centers, _ = _clustered(rng, n, d)
    q, _ = _queries(rng, centers, b, d)
    vals = rng.integers(0, 1_000_000, n).astype(np.float32)
    k = rng.choice(sel_ks, b)
    width = 1_000_000 / k
    lo = rng.uniform(0, np.maximum(1_000_000 - width, 1))
    hi = lo + width
    sel = np.array([((vals >= l) & (vals <= h)).mean()
                    for l, h in zip(lo, hi)])
    return FilteredDataset("msturing_range", xb,
                           F.range_table(vals, device), q,
                           F.range_filters(lo, hi, device), sel)


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


def laion_like(n=20000, d=64, b=256, n_keywords=30, tags_per_point=3,
               correlation="random", seed=0, device=None) -> FilteredDataset:
    """Keyword clusters; subset filter with controllable query correlation.
    Builds an [n, n_keywords, d] temporary on the host: test sizes only."""
    rng = np.random.default_rng(seed)
    keywords = rng.normal(size=(n_keywords, d)) * 4.0
    xb = (keywords[rng.integers(0, n_keywords, n)]
          + rng.normal(size=(n, d))).astype(np.float32)
    # each point tagged with its `tags_per_point` nearest keyword centres
    d2 = ((xb[:, None, :] - keywords[None]) ** 2).sum(-1)
    tags = np.argsort(d2, axis=1)[:, :tags_per_point]
    bits = np.zeros((n, n_keywords), bool)
    np.put_along_axis(bits, tags, True, axis=1)

    q = (keywords[rng.integers(0, n_keywords, b)]
         + rng.normal(size=(b, d))).astype(np.float32)
    qd2 = ((q[:, None, :] - keywords[None]) ** 2).sum(-1)
    if correlation == "positive":
        kw = np.argmin(qd2, axis=1)
    elif correlation == "negative":
        kw = np.argmax(qd2, axis=1)
    else:
        kw = rng.integers(0, n_keywords, b)
    fbits = np.zeros((b, n_keywords), bool)
    fbits[np.arange(b), kw] = True
    sel = bits[:, kw].mean(axis=0)
    return FilteredDataset(f"laion_like_{correlation}", xb,
                           F.subset_table(bits, n_keywords, device=device), q,
                           F.subset_filters(fbits, n_keywords, device=device),
                           sel)


REGISTRY = {
    "sift_like": sift_like,
    "msturing_range": msturing_range,
    "msturing_subset": msturing_subset,
    "msturing_bool": msturing_bool,
    "laion_like": laion_like,
}


def make(name: str, **kw) -> FilteredDataset:
    return REGISTRY[name](**kw)
