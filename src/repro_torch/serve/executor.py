"""Search executor: the routes behind every entry point, and their cache
(counterpart of ``repro.serve.executor``).

PyTorch runs eagerly, so there is nothing to compile; the route-key cache
keeps the reference's keys

    (route, layout, dtype, k, ls, max_iters, filter kind, *route extras)

and holds the route closures built for them, so the set of route variants
a process has served is enumerable (``cache_keys()``) exactly as in the
reference.

Routes (serve/planner.py picks between the first three):

  prefilter  - masked brute-force scan over filter-passing rows
               (core/ground_truth.py). On the card it runs the
               ``gather_dist_tile`` and ``bitset_dist`` kernels.
  graph      - JAG traversal (core/beam_search.py), default or fused
               layout, f32 or int8 vector lanes (int8: traversal on the
               codes, then an exact re-rank). The fused layout's expansion
               runs the ``fused_expand`` kernel on the card.
  postfilter - unfiltered traversal with an ls-wide beam, the filter
               applied to the survivors.
  delta      - exact masked scan over a streaming index's delta segment,
               ids offset past the graph segment (the prefilter's scan and
               kernels). Only for an index with ``delta_arrays()``
               (``repro_torch.stream.StreamingJAGIndex``).
  merge      - folds the delta's top-k into any base route's, exactly.

Every cache is keyed by the index's data epoch (``JAGIndex.epoch`` is 0
forever; a ``StreamingJAGIndex`` bumps it on every insert and compaction):
a rolled epoch evicts every route closure, planner probe and engine, so a
grown index never routes on a stale probe or serves a pre-compaction
layout. ``use_kernel`` defaults to whether the index lives on the card.

Telemetry hooks (``repro_torch.obs``): ``miss_hook(epoch_key)`` fires once
per route closure built for a new key, ``roll_hook(epoch)`` once per
epoch-driven eviction; both run on the host, outside every route.
``cost_router`` hands the planner the attached cost model's router.
"""
from __future__ import annotations

import weakref
from functools import partial
from typing import Callable, Tuple

import torch

from ..core.beam_search import SearchResult, greedy_search
from ..core.distances import (INF, gathered_d2, lex_sort, query_key_fn,
                              unfiltered_key_fn)
from ..core.filters import FilterExpr, matches, n_leaves
from ..core.ground_truth import exact_filtered_knn
from ..core.quantized import make_int8_dist_fn, rerank_exact
from .engine import FusedEngine

LAYOUTS = ("default", "fused")
VEC_DTYPES = ("f32", "int8")


class Executor:
    """Owns the route cache and route implementations for one index; holds
    references to the index's tensors, never copies.

    The index owns its executor, so the executor and its route closures
    hold the index only weakly: a dropped index frees its device memory at
    once, without waiting for the cyclic garbage collector."""

    def __init__(self, index):
        self._index = weakref.ref(index)
        self._cache: dict = {}
        self._engines: dict = {}
        self._samples: dict = {}
        self._cache_epoch: int = self.epoch
        # analysis hook: when a list, run() appends every (key, make, args)
        # it executes, so repro_torch.analysis.audit can replay the exact
        # route closures this cache serves. None in serving.
        self.trace_log: list | None = None
        # telemetry hooks (repro_torch.obs), host-side only
        self.miss_hook: Callable | None = None
        self.roll_hook: Callable | None = None

    @property
    def index(self):
        """The index this executor serves (alive while it is in use)."""
        idx = self._index()
        if idx is None:
            raise ReferenceError("the executor's index has been dropped")
        return idx

    @property
    def use_kernel(self) -> bool:
        return self.index.device.type == "cuda"

    # -- cache plumbing ----------------------------------------------------
    @property
    def epoch(self) -> int:
        """The index's data epoch (0 forever for a frozen JAGIndex)."""
        return getattr(self.index, "epoch", 0)

    def _roll_epoch(self) -> None:
        """Evict every cache built against an earlier data epoch."""
        e = self.epoch
        if e != self._cache_epoch:
            self._cache.clear()
            self._samples.clear()
            self._engines.clear()
            self._cache_epoch = e
            if self.roll_hook is not None:
                self.roll_hook(e)

    def sample_ids(self, n: int, n_samples: int, seed: int = 0):
        """Planner probe rows, cached per executor (so per index) and per
        data epoch: a grown table is never probed over stale rows."""
        self._roll_epoch()
        key = (self._cache_epoch, n, n_samples, seed)
        ids = self._samples.get(key)
        if ids is None:
            from .planner import sample_ids
            ids = self._samples[key] = sample_ids(n, n_samples, seed,
                                                  self.index.device)
        return ids

    def run(self, key: Tuple, make: Callable[[], Callable], *args):
        """Run the route closure cached under ``(epoch,) + key``
        (``make()`` is called on the first use of a key in an epoch)."""
        self._roll_epoch()
        if self.trace_log is not None:
            self.trace_log.append((key, make, args))
        epoch_key = (self._cache_epoch,) + key
        fn = self._cache.get(epoch_key)
        if fn is None:
            if self.miss_hook is not None:
                self.miss_hook(epoch_key)
            fn = self._cache[epoch_key] = make()
        return fn(*args)

    def cache_keys(self, full: bool = False) -> Tuple:
        """Route keys of the current epoch (an epoch roll empties them);
        ``full=True`` keeps each key's leading epoch."""
        self._roll_epoch()
        return tuple(self._cache) if full else tuple(
            k[1:] for k in self._cache)

    def cost_router(self, *, k: int, ls: int, filt=None):
        """The index's ``cost.CostModelRouter`` for this search shape, or
        None (the planner's static thresholds).

        The router predicts every base route's cost at the live (n, d, k,
        ls) and folds the delta-scan tax of a streaming index's
        ``delta.n`` rows into each prediction. A model that does not cover
        all three base routes counts as absent. ``filt`` gives a compound
        expression's clause count to the prefilter's log(n_clauses) term.
        """
        model = getattr(self.index, "cost_model", None)
        if model is None:
            return None
        from ..cost.model import BASE_ROUTES, CostModelRouter
        metric = getattr(self.index, "cost_metric", "us")
        if not model.covers(BASE_ROUTES, metric):
            return None
        idx = self.index
        delta_n = idx.delta.n if hasattr(idx, "delta_arrays") else 0
        clauses = 1 if filt is None else n_leaves(filt)
        return CostModelRouter(model, n=int(idx.xb.shape[0]),
                               d=int(idx.xb.shape[1]), k=k, ls=ls,
                               delta_n=delta_n, metric=metric,
                               n_leaves=clauses)

    def engine(self, vec_dtype: str = "f32") -> FusedEngine:
        """FusedEngine over the index's packed layout, per epoch."""
        self._roll_epoch()
        if vec_dtype not in self._engines:
            self._engines[vec_dtype] = FusedEngine(
                self.index.fused_layout(vec_dtype))
        return self._engines[vec_dtype]

    # -- graph route (JAG traversal; Algorithm 2) --------------------------
    def graph(self, queries, filt, *, k: int, ls: int, max_iters: int,
              layout: str = "default", dtype: str = "f32",
              introspect: bool = False):
        """JAG traversal. int8 traverses with ``k = ls`` over the codes
        (the fused layout's lanes, or ``index.quantized()`` with the split
        layout), then re-ranks the beam with the f32 rows.

        ``introspect=True`` (its own cache-key component) returns
        ``(SearchResult, TraversalStats)``: per-query hops, saturation step
        and dead ends, with ids and keys bit for bit those of the standard
        route."""
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be 'default' or 'fused', "
                             f"got {layout!r}")
        if dtype not in VEC_DTYPES:
            raise ValueError(f"dtype must be 'f32' or 'int8', got {dtype!r}")
        idx = self.index
        key = ("graph", layout, dtype, k, ls, max_iters, filt.kind)
        if introspect:
            key = key + ("introspect",)
        fetch_fn = self.engine(dtype).fetch_fn if layout == "fused" else None
        # the split int8 route walks the codes under make_int8_dist_fn
        xs, xs_norm, dist_fn = idx.xb, idx.xb_norm, gathered_d2
        if dtype == "int8" and layout == "default":
            xs, scale, xs_norm = idx.quantized()
            dist_fn = make_int8_dist_fn(scale)

        ref = self._index

        def make():
            def run(q, filt, xs, xs_norm, dist_fn, fetch_fn):
                idx = ref()
                out = greedy_search(idx.graph, xs, xs_norm, idx.attr, q,
                                    idx.entry, query_key_fn(filt), ls=ls,
                                    k=k if dtype == "f32" else ls,
                                    max_iters=max_iters, dist_fn=dist_fn,
                                    fetch_fn=fetch_fn, introspect=introspect)
                if dtype == "f32":
                    return out
                res, stats = out if introspect else (out, None)
                i, p, s = rerank_exact(idx.xb, idx.xb_norm, res.ids,
                                       res.primary, q, k)
                res = SearchResult(i, p, s, res.vlog, res.n_expanded,
                                   res.n_dist)
                return (res, stats) if introspect else res
            return run
        return self.run(key, make, queries, filt, xs, xs_norm, dist_fn,
                        fetch_fn)

    # -- unfiltered traversal ----------------------------------------------
    def unfiltered(self, queries, *, k: int, ls: int,
                   max_iters: int) -> SearchResult:
        key = ("unfiltered", "default", "f32", k, ls, max_iters, None)
        ref = self._index

        def make():
            def run(q):
                idx = ref()
                return greedy_search(idx.graph, idx.xb, idx.xb_norm,
                                     idx.attr, q, idx.entry,
                                     unfiltered_key_fn(), ls=ls, k=k,
                                     max_iters=max_iters)
            return run
        return self.run(key, make, queries)

    # -- scan routes (prefilter, delta) -------------------------------------
    def _scan(self, key: Tuple, xb, attr, queries, filt, *, k: int,
              block: int, use_kernel: bool, offset: int = 0
              ) -> SearchResult:
        """Masked exact scan adapted to the SearchResult contract, behind
        both scan routes: primary is 0 where a valid neighbour was found,
        INF on -1 padding; ids are offset by ``offset``; n_dist counts
        valid points scanned; vlog is ``[B, 0]`` (no traversal). The offset
        is a call argument, so one cached closure serves every shard of a
        sharded index."""
        def make():
            def run(xb, attr, q, filt, offset):
                gt = exact_filtered_knn(xb, attr, q, filt, k=k, block=block,
                                        use_kernel=use_kernel)
                B = q.shape[0]
                ids = (gt.ids if offset == 0
                       else torch.where(gt.ids >= 0, gt.ids + offset, -1))
                prim = torch.where(gt.ids >= 0, 0.0, INF)
                return SearchResult(ids, prim, gt.d2,
                                    torch.zeros((B, 0), dtype=torch.int32,
                                                device=q.device),
                                    torch.zeros((B,), dtype=torch.int32,
                                                device=q.device), gt.n_dist)
            return run
        return self.run(key, make, xb, attr, queries, filt, offset)

    def _reorder_compound(self, filt):
        """Short-circuit-optimal clause order for a compound expression,
        from each leaf's validity on the cached sample rows. Result-
        identical; only the scan's ``n_feval`` accounting changes."""
        if not isinstance(filt, FilterExpr) or n_leaves(filt) < 2:
            return filt
        from .planner import leaf_validity, reorder_clauses
        ids = self.sample_ids(self.index.attr.n, 1024, 0)
        key = ("leafval", "default", "bool", 0, 0, 0, filt.kind,
               int(ids.shape[0]))
        valid = self.run(key, lambda: leaf_validity,
                         filt, self.index.attr, ids)
        v = valid.cpu().numpy()
        return reorder_clauses(filt, list(v.reshape(v.shape[0], -1)))

    def prefilter(self, queries, filt, *, k: int, block: int = 4096,
                  use_kernel: bool | None = None) -> SearchResult:
        """Masked exact scan over the index's (graph-segment) rows."""
        if use_kernel is None:
            use_kernel = self.use_kernel
        filt = self._reorder_compound(filt)
        idx = self.index
        key = ("prefilter", "default", "f32", k, 0, 0, filt.kind, block,
               use_kernel)
        return self._scan(key, idx.xb, idx.attr, queries, filt, k=k,
                          block=block, use_kernel=use_kernel)

    def delta(self, queries, filt, *, k: int, block: int = 4096,
              use_kernel: bool | None = None) -> SearchResult:
        """Exact masked scan over a streaming index's delta segment, ids
        offset past the graph segment, so ``merge`` folds them into any
        base route's top-k as if the concatenation had been searched. The
        block is capped at the delta's row count: a 60-row delta never
        pays a 4096-row tile."""
        if not hasattr(self.index, "delta_arrays"):
            raise TypeError("delta route needs a streaming index exposing "
                            "delta_arrays(); JAGIndex is frozen")
        if use_kernel is None:
            use_kernel = self.use_kernel
        xv, dattr, offset = self.index.delta_arrays()
        block = max(1, min(block, int(xv.shape[0])))
        key = ("delta", "default", "f32", k, 0, 0, filt.kind, block,
               use_kernel, offset)
        return self._scan(key, xv, dattr, queries, filt, k=k, block=block,
                          use_kernel=use_kernel, offset=offset)

    def merge(self, base: SearchResult, extra: SearchResult, *,
              k: int) -> SearchResult:
        """Fold two per-query top-k results into one exact top-k
        (``dispatch.merge_topk``: ties resolve to ``base``, as a scan of
        base rows before delta rows)."""
        from .dispatch import merge_topk
        key = ("merge", "default", "f32", k, 0, 0, None)
        return self.run(key, lambda: partial(merge_topk, k=k), base, extra)

    # -- postfilter route (ls-wide unfiltered beam + filter) ---------------
    def postfilter(self, queries, filt, *, k: int, ls: int,
                   max_iters: int) -> SearchResult:
        """Unfiltered traversal keeping the ls-beam, then the k best
        filter-passing survivors. n_dist counts the traversal's distance
        computations plus the filter evaluations on the surviving beam."""
        key = ("postfilter", "default", "f32", k, ls, max_iters, filt.kind)
        ref = self._index

        def make():
            def run(q, filt):
                idx = ref()
                res = greedy_search(idx.graph, idx.xb, idx.xb_norm,
                                    idx.attr, q, idx.entry,
                                    unfiltered_key_fn(), ls=ls, k=ls,
                                    max_iters=max_iters)
                ids = res.ids
                ok = matches(filt, idx.attr.gather(ids.clamp_min(0)))
                ok = ok & (ids >= 0)
                prim, sec, idsm = lex_sort(
                    torch.where(ok, 0.0, INF),
                    torch.where(ok, res.secondary, INF),
                    torch.where(ok, ids, -1))
                n_dist = res.n_dist + torch.sum(ids >= 0, dim=1,
                                                dtype=torch.int32)
                return SearchResult(idsm[:, :k], prim[:, :k], sec[:, :k],
                                    res.vlog, res.n_expanded, n_dist)
            return run
        return self.run(key, make, queries, filt)
