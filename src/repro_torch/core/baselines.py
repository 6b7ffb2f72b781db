"""Baseline filtered-ANN algorithms (paper §4.2 / Appendix D.4), the
counterpart of ``repro.core.baselines``.

Implemented by mechanism, with the paper baseline each one stands in for:

  post_filter       - Post-Filtering: unfiltered Vamana-style search with an
                      oversampled beam, filter applied to the results.
  pre_filter        - Pre-Filtering: exact masked scan (ground_truth module).
  binary_jag        - FilteredVamana-flavoured: strict-attribute build (T={0})
                      + binary match/non-match traversal, i.e. JAG with the
                      paper's "trivial" dist_F/dist_A (§3.1 Discussion).
  acorn             - ACORN-gamma-flavoured: attribute-oblivious graph,
                      two-hop expansion at query time, predicate-passing
                      candidates prioritized.
  rwalks            - RWalks-flavoured: attribute-oblivious graph + random-
                      walk attribute diffusion at build; query key =
                      h * dist_F(aggregated attrs) + dist.
  stitched (labels) - StitchedVamana-flavoured: one pure-vector subgraph per
                      label, queries routed to their label's subgraph.

All baselines share the batched GreedySearch / batch-build substrate, so
QPS and distance-computation comparisons against JAG are apples-to-apples,
and they run through the index's ``serve.Executor`` cache under the
reference's route keys. The route closures take the index's tensors as
arguments, never hold them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device, to_tensor
from .beam_search import SearchResult, greedy_search
from .distances import INF, dist_f, hard_filter_key_fn, lex_sort
from .filters import (BOOLEAN, LABEL, RANGE, SUBSET, AttrTable, FilterBatch,
                      as_filter, matches, pack_bits)
from .jag import JAGConfig, JAGIndex


def build_unfiltered(xb, attr: AttrTable, cfg: JAGConfig,
                     device=None) -> JAGIndex:
    """Pure vector-distance graph (threshold quantile 100% only)."""
    c = dataclasses.replace(cfg, mode="threshold",
                            threshold_quantiles=(1.0,))
    return JAGIndex.build(xb, attr, c, device=device)


def build_binary(xb, attr: AttrTable, cfg: JAGConfig,
                 device=None) -> JAGIndex:
    """Strict-attribute + vector graph: thresholds {0%, 100%}."""
    c = dataclasses.replace(cfg, mode="threshold",
                            threshold_quantiles=(1.0, 0.0))
    return JAGIndex.build(xb, attr, c, device=device)


# ---------------------------------------------------------------------------
# post-filtering
# ---------------------------------------------------------------------------

def post_filter_search(index: JAGIndex, queries, filt: FilterBatch,
                       k: int = 10, ls: int = 64,
                       max_iters: int = 0) -> SearchResult:
    """Unfiltered search with beam ls, keep the k best filter-passing: the
    executor's postfilter route, the one ``search_auto`` dispatches to at
    high selectivity."""
    return index.executor.postfilter(index._q(queries), as_filter(filt),
                                     k=k, ls=ls,
                                     max_iters=max_iters or 2 * ls)


# ---------------------------------------------------------------------------
# binary (FilteredVamana-flavoured) and ACORN-gamma-flavoured traversals
# ---------------------------------------------------------------------------

def _exact_only(res: SearchResult) -> SearchResult:
    """Re-key to the exact dist_F == 0 convention for recall accounting:
    ids whose hard key is not exactly 0 become -1, their primary INF."""
    ok = res.primary == 0.0
    return SearchResult(torch.where(ok, res.ids, -1),
                        torch.where(ok, 0.0, INF), res.secondary,
                        res.vlog, res.n_expanded, res.n_dist)


def _hard_traversal(index: JAGIndex, key, queries, filt, *, k: int, ls: int,
                    max_iters: int, make_expand=None) -> SearchResult:
    """greedy_search under ``hard_filter_key_fn`` through the executor's
    cache; ``make_expand(graph)`` gives the expansion (default 1-hop)."""
    def make():
        def run(graph, xb, xb_norm, attr, q, filt, entry):
            return greedy_search(
                graph, xb, xb_norm, attr, q, entry, hard_filter_key_fn(filt),
                ls=ls, k=k, max_iters=max_iters,
                expand_fn=None if make_expand is None else make_expand(graph))
        return run
    res = index.executor.run(key, make, index.graph, index.xb,
                             index.xb_norm, index.attr, index._q(queries),
                             filt, index.entry)
    return _exact_only(res)


def binary_search(index: JAGIndex, queries, filt: FilterBatch, k: int = 10,
                  ls: int = 64, max_iters: int = 0) -> SearchResult:
    max_iters = max_iters or 2 * ls
    filt = as_filter(filt)
    key = ("binary", "default", "f32", k, ls, max_iters, filt.kind)
    return _hard_traversal(index, key, queries, filt, k=k, ls=ls,
                           max_iters=max_iters)


def acorn_search(index: JAGIndex, queries, filt: FilterBatch, k: int = 10,
                 ls: int = 64, max_iters: int = 0,
                 hop2_per_nbr: int = 4) -> SearchResult:
    """Two-hop candidate pool; predicate-passing candidates keyed first.
    Each expansion is the W one-hop neighbours, then the first
    ``h2 = min(hop2_per_nbr, W)`` neighbours of each (-1 where the first
    hop is -1): C = W + W * h2 candidates."""
    max_iters = max_iters or 2 * ls
    filt = as_filter(filt)
    W = int(index.graph.shape[1])
    h2 = min(hop2_per_nbr, W)
    key = ("acorn", "default", "f32", k, ls, max_iters, filt.kind, h2)

    def make_expand(graph):
        def expand(p):
            one = graph[p]                                     # [B, W]
            two = graph[one.clamp_min(0)][..., :h2]            # [B, W, h2]
            two = torch.where((one >= 0)[:, :, None], two, -1)
            return torch.cat([one, two.reshape(one.shape[0], -1)], dim=1)
        return expand
    return _hard_traversal(index, key, queries, filt, k=k, ls=ls,
                           max_iters=max_iters, make_expand=make_expand)


# ---------------------------------------------------------------------------
# RWalks-flavoured: random-walk attribute diffusion
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RWalksIndex:
    base: JAGIndex
    agg: AttrTable          # aggregated (diffused) attributes
    h: float                # weight of the filter-distance term


def _one_hot_words(labels: torch.Tensor, L: int) -> torch.Tensor:
    """Labels [...] -> packed one-hot words [..., ceil(L/32)]."""
    return pack_bits(torch.nn.functional.one_hot(labels.long(), L).bool())


def build_rwalks(xb, attr: AttrTable, cfg: JAGConfig, m: int = 5,
                 depth: int = 3, h: float = 0.1, seed: int = 0,
                 index: Optional[JAGIndex] = None,
                 device=None) -> RWalksIndex:
    """m random walks of length ``depth`` aggregate attributes per node.

    Each step draws the walks' neighbour slots from numpy's generator on
    the host (the reference's draws, in its order) and moves them to the
    device, so the walks and the aggregated table equal the reference's
    bit for bit."""
    base = (index if index is not None
            else build_unfiltered(xb, attr, cfg, device=device))
    graph = base.graph
    dev = graph.device
    attr = attr.to(dev)
    N, W = graph.shape
    rng = np.random.default_rng(seed)
    cur = torch.arange(N, dtype=torch.int32, device=dev)[:, None].expand(
        N, m)

    L = 0
    if attr.kind == LABEL:
        L = int(attr.data["label"].max()) + 1
        agg = {"bits": _one_hot_words(attr.data["label"], L)}
    elif attr.kind == RANGE:
        agg = {"lo": attr.data["value"], "hi": attr.data["value"]}
    elif attr.kind == SUBSET:
        agg, L = {"bits": attr.data["bits"]}, attr.n_bits
    elif attr.kind == BOOLEAN:   # diffuse assignments as a seen-set OR
        agg, L = {"assign": attr.data["assign"]}, attr.n_bits
    else:
        raise ValueError(attr.kind)

    for _ in range(depth):
        r = torch.as_tensor(rng.integers(0, W, (N, m)), dtype=torch.int64,
                            device=dev)
        nxt = graph[cur.long(), r]
        cur = torch.where(nxt >= 0, nxt, cur)
        cc = cur.clamp_min(0).long()
        if attr.kind == RANGE:
            v = attr.data["value"][cc]
            agg = {"lo": torch.minimum(agg["lo"], v.min(dim=1).values),
                   "hi": torch.maximum(agg["hi"], v.max(dim=1).values)}
        elif attr.kind in (LABEL, SUBSET):
            src = (_one_hot_words(attr.data["label"][cc], L)
                   if attr.kind == LABEL else attr.data["bits"][cc])
            acc = agg["bits"]
            for j in range(m):
                acc = acc | src[:, j]
            agg = {"bits": acc}
        # BOOLEAN: keep its own assignment (diffusion undefined for
        # predicates)
    kind = SUBSET if attr.kind in (LABEL, SUBSET) else attr.kind
    return RWalksIndex(base, AttrTable(kind, agg, n_bits=L or attr.n_bits),
                       h)


def _rwalks_dist_f(filt: FilterBatch, agg_kind: str,
                   attrs: Dict[str, torch.Tensor]) -> torch.Tensor:
    if filt.kind == LABEL:   # agg is a label bitset; f passes if label seen
        lab = filt.data["label"][:, None]
        bits = attrs["bits"]                                  # [B, C, Wd]
        word = (lab // 32).long()[..., None].expand(
            bits.shape[:-1] + (1,))
        w = torch.gather(bits, -1, word)[..., 0]
        return (((w >> (lab % 32)) & 1) == 0).to(torch.float32)
    if filt.kind == RANGE:   # gap between query range and node interval
        lo = filt.data["lo"][:, None]
        hi = filt.data["hi"][:, None]
        return (torch.clamp_min(lo - attrs["hi"], 0.0)
                + torch.clamp_min(attrs["lo"] - hi, 0.0))
    return dist_f(filt, attrs)


def rwalks_search(rw: RWalksIndex, queries, filt: FilterBatch, k: int = 10,
                  ls: int = 64, max_iters: int = 0) -> SearchResult:
    """Traverse with the full ls beam under h * dist_F(aggregated) +
    dist, then keep exact matches re-ranked by vector distance."""
    max_iters = max_iters or 2 * ls
    filt = as_filter(filt)
    base = rw.base
    # k only shapes the post-validation slice below, not the traversal
    # (which keeps the full ls beam), so it stays out of the key
    key = ("rwalks", "default", "f32", 0, ls, max_iters, filt.kind,
           rw.agg.kind)

    def make():
        def run(graph, xb, xb_norm, attr, agg, h, q, filt, entry):
            def key_fn(ids, _attrs, d2):
                ag = agg.gather(ids)
                return (h * _rwalks_dist_f(filt, agg.kind, ag)
                        + torch.sqrt(d2), d2)
            return greedy_search(graph, xb, xb_norm, attr, q, entry, key_fn,
                                 ls=ls, k=ls, max_iters=max_iters)
        return run
    h = torch.tensor(rw.h, dtype=torch.float32, device=base.device)
    res = base.executor.run(key, make, base.graph, base.xb, base.xb_norm,
                            base.attr, rw.agg, h, base._q(queries), filt,
                            base.entry)
    # post-validate: keep exact matches only, re-ranked by vector distance
    ids = res.ids
    ok = matches(filt, base.attr.gather(ids.clamp_min(0))) & (ids >= 0)
    prim, sec, idsm = lex_sort(torch.where(ok, 0.0, INF),
                               torch.where(ok, res.secondary, INF),
                               torch.where(ok, ids, -1))
    return SearchResult(idsm[:, :k], prim[:, :k], sec[:, :k], res.vlog,
                        res.n_expanded, res.n_dist)


# ---------------------------------------------------------------------------
# StitchedVamana-flavoured (label filters)
# ---------------------------------------------------------------------------

class StitchedLabelIndex:
    """One pure-vector subgraph per label; queries routed by label. Built on
    ``device`` (default "cuda"); sub-index ``lab`` serves the global ids
    ``self.sub[lab][1]``."""

    def __init__(self, xb, attr: AttrTable, cfg: JAGConfig, device=None):
        assert attr.kind == LABEL
        dev = resolve_device(device)
        labels = attr.data["label"].cpu().numpy()
        xb = to_tensor(xb, torch.float32, dev)
        self.device = dev
        self.sub: Dict[int, tuple] = {}
        for lab in np.unique(labels):
            ids = np.flatnonzero(labels == lab)
            sub_attr = AttrTable(LABEL, {"label": torch.as_tensor(
                labels[ids], dtype=torch.int32, device=dev)})
            c = dataclasses.replace(
                cfg, mode="threshold", threshold_quantiles=(1.0,),
                batch_size=min(cfg.batch_size, max(8, len(ids) // 4)))
            gids = torch.as_tensor(ids, dtype=torch.int32, device=dev)
            idx = JAGIndex.build(xb[gids.long()], sub_attr, c, device=dev)
            self.sub[int(lab)] = (idx, gids)

    def search(self, queries, filt, k=10, ls=64) -> SearchResult:
        """Route each query to its label subgraph (grouped by label).
        ``vlog`` and ``n_expanded`` are None, as in the reference."""
        filt = as_filter(filt)
        q = to_tensor(queries, torch.float32, self.device)
        qlab = filt.data["label"].cpu().numpy()
        B = qlab.shape[0]
        ids = torch.full((B, k), -1, dtype=torch.int32, device=self.device)
        d2 = torch.full((B, k), INF, device=self.device)
        ndist = torch.zeros((B,), dtype=torch.int32, device=self.device)
        for lab, (idx, gids) in self.sub.items():
            sel = np.flatnonzero(qlab == lab)
            if sel.size == 0:
                continue
            sel = torch.as_tensor(sel, device=self.device)
            res = idx.search_unfiltered(q[sel], k=k, ls=ls)
            rid = res.ids
            ids[sel] = torch.where(rid >= 0, gids[rid.clamp_min(0).long()],
                                   -1)
            d2[sel] = res.secondary
            ndist[sel] = res.n_dist
        prim = torch.where(ids >= 0, 0.0, INF)
        return SearchResult(ids, prim, d2, None, None, ndist)
