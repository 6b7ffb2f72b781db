"""Frozen copy of the port's synthetic data generators
(``repro_torch.data.synthetic``: ``msturing_subset``, ``sift_like``).

The draws are the originals', from numpy's generator in the same order,
so for a seed and the same sizes these return the same vectors,
attributes, query vectors and filters (``tests/test_jagbench_parts.py``
holds them equal). Two departures, neither of which changes a draw that
comes before it:

* they return raw numpy arrays (boolean subset bits, integer labels) and
  leave the program's tables and filters to ``kinds/<kind>.py``; the
  per-query selectivity the originals compute on the host (a pass over
  all N rows for every query) is left out, since the reference counts
  matching rows itself;
* ``balanced_batch=B`` draws each query's filter as a shuffled, evenly
  filled batch of B: the required-bit counts (or labels) of every batch
  of B queries are the same multiset, only their order comes from the
  seed. With ``balanced_batch=0`` the filter draw is the original's
  uniform draw. A seed then changes which rows and queries a run sees,
  not how much of each route's work it does.
"""
from __future__ import annotations

import numpy as np


def _clustered(rng, n, d, n_clusters=32, spread=1.0, scale=4.0):
    centers = rng.normal(size=(n_clusters, d)) * scale
    asg = rng.integers(0, n_clusters, n)
    x = centers[asg] + rng.normal(size=(n, d)) * spread
    return x.astype(np.float32), centers, asg


def _queries(rng, centers, b, d, spread=1.0):
    asg = rng.integers(0, centers.shape[0], b)
    return (centers[asg] + rng.normal(size=(b, d)) * spread).astype(
        np.float32), asg


def pack_u32(bits: np.ndarray) -> np.ndarray:
    """bool [M, L] -> little-endian uint32 words [M, ceil(L/32)]."""
    b = np.packbits(bits, axis=1, bitorder="little")
    b = np.pad(b, ((0, 0), (0, (-b.shape[1]) % 4)))
    return np.ascontiguousarray(b).view("<u4")


def _balanced(rng, values, b, batch):
    """Each consecutive ``batch`` of the ``b`` draws is ``values`` repeated
    to ``batch`` entries and shuffled."""
    if b % batch:
        raise ValueError(f"{b} draws are not whole batches of {batch}")
    fill = np.resize(np.asarray(values), batch)
    return np.concatenate([rng.permutation(fill) for _ in range(b // batch)])


def msturing_subset(n=20000, d=64, b=256, n_attrs=30, seed=0,
                    req_ks=(0, 2, 4, 6, 8, 10, 12), balanced_batch=0):
    """30 Bernoulli(1/2) attributes; a query requires k of them. Returns
    (xb f32 [n, d], bits bool [n, n_attrs], queries f32 [b, d],
    fbits bool [b, n_attrs])."""
    rng = np.random.default_rng(seed)
    xb, centers, _ = _clustered(rng, n, d)
    q, _ = _queries(rng, centers, b, d)
    bits = rng.random((n, n_attrs)) < 0.5
    if balanced_batch:
        k = _balanced(rng, req_ks, b, balanced_batch)
    else:
        k = rng.choice(req_ks, b)
    fbits = np.zeros((b, n_attrs), bool)
    for i in range(b):
        fbits[i, rng.choice(n_attrs, k[i], replace=False)] = True
    return xb, bits, q, fbits


def sift_like(n=20000, d=64, b=256, n_labels=12, seed=0, balanced_batch=0):
    """Label filter: a uniform label in {0..n_labels-1} a row; a query asks
    for one label. Returns (xb f32 [n, d], labels int [n], queries f32
    [b, d], qlabels int [b])."""
    rng = np.random.default_rng(seed)
    xb, centers, _ = _clustered(rng, n, d)
    q, _ = _queries(rng, centers, b, d)
    labels = rng.integers(0, n_labels, n)
    if balanced_batch:
        qlab = _balanced(rng, np.arange(n_labels), b, balanced_batch)
    else:
        qlab = rng.integers(0, n_labels, b)
    return xb, labels, q, qlab
