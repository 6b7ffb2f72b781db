"""Search executor: the routes behind every entry point, and their cache
(counterpart of ``repro.serve.executor``).

PyTorch runs eagerly, so there is nothing to compile; the route-key cache
keeps the reference's keys

    (route, layout, dtype, k, ls, max_iters, filter kind, *route extras)

and holds the route closures built for them, so the set of route variants
a process has served is enumerable (``cache_keys()``) exactly as in the
reference.

Routes (serve/planner.py picks between them):

  prefilter  - masked brute-force scan over filter-passing rows
               (core/ground_truth.py). On the card it runs the
               ``gather_dist_tile`` and ``bitset_dist`` kernels.
  graph      - JAG traversal (core/beam_search.py), default or fused f32
               layout. The fused layout's expansion runs the
               ``fused_expand`` kernel on the card.
  postfilter - unfiltered traversal with an ls-wide beam, the filter
               applied to the survivors.

``use_kernel`` defaults to whether the index lives on the card.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core.beam_search import SearchResult, greedy_search
from ..core.distances import INF, lex_sort, query_key_fn, unfiltered_key_fn
from ..core.filters import FilterExpr, matches, n_leaves
from ..core.ground_truth import exact_filtered_knn
from .engine import FusedEngine

LAYOUTS = ("default", "fused")
VEC_DTYPES = ("f32",)


class Executor:
    """Owns the route cache and route implementations for one index; holds
    references to the index's tensors, never copies."""

    def __init__(self, index):
        self.index = index
        self._cache: dict = {}
        self._engines: dict = {}
        self._samples: dict = {}

    @property
    def use_kernel(self) -> bool:
        return self.index.xb.is_cuda

    def sample_ids(self, n: int, n_samples: int, seed: int = 0):
        """Planner probe rows, cached per executor (so per index)."""
        key = (n, n_samples, seed)
        ids = self._samples.get(key)
        if ids is None:
            from .planner import sample_ids
            ids = self._samples[key] = sample_ids(n, n_samples, seed,
                                                  self.index.xb.device)
        return ids

    def run(self, key: Tuple, make: Callable[[], Callable], *args):
        """Run the route closure cached under ``key`` (``make()`` is called
        on the first use of a key only)."""
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = make()
        return fn(*args)

    def cache_keys(self) -> Tuple:
        return tuple(self._cache)

    def engine(self, vec_dtype: str = "f32") -> FusedEngine:
        """FusedEngine over the index's packed layout."""
        if vec_dtype not in self._engines:
            self._engines[vec_dtype] = FusedEngine(
                self.index.fused_layout(vec_dtype))
        return self._engines[vec_dtype]

    # -- graph route (JAG traversal; Algorithm 2) --------------------------
    def graph(self, queries, filt, *, k: int, ls: int, max_iters: int,
              layout: str = "default", dtype: str = "f32") -> SearchResult:
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be 'default' or 'fused', "
                             f"got {layout!r}")
        if dtype not in VEC_DTYPES:
            raise ValueError(f"dtype must be 'f32' (the int8 lanes are not "
                             f"ported yet), got {dtype!r}")
        idx = self.index
        key = ("graph", layout, dtype, k, ls, max_iters, filt.kind)
        fetch_fn = self.engine("f32").fetch_fn if layout == "fused" else None

        def make():
            def run(q, filt):
                return greedy_search(idx.graph, idx.xb, idx.xb_norm,
                                     idx.attr, q, idx.entry,
                                     query_key_fn(filt), ls=ls, k=k,
                                     max_iters=max_iters, fetch_fn=fetch_fn)
            return run
        return self.run(key, make, queries, filt)

    # -- unfiltered traversal ----------------------------------------------
    def unfiltered(self, queries, *, k: int, ls: int,
                   max_iters: int) -> SearchResult:
        idx = self.index
        key = ("unfiltered", "default", "f32", k, ls, max_iters, None)

        def make():
            def run(q):
                return greedy_search(idx.graph, idx.xb, idx.xb_norm,
                                     idx.attr, q, idx.entry,
                                     unfiltered_key_fn(), ls=ls, k=k,
                                     max_iters=max_iters)
            return run
        return self.run(key, make, queries)

    # -- prefilter route (masked exact scan) -------------------------------
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
        """Masked exact scan over the index's rows, adapted to the
        SearchResult contract: primary is 0 where a valid neighbour was
        found, INF on -1 padding; n_dist counts valid points scanned; vlog
        is ``[B, 0]`` (no traversal)."""
        if use_kernel is None:
            use_kernel = self.use_kernel
        filt = self._reorder_compound(filt)
        idx = self.index
        key = ("prefilter", "default", "f32", k, 0, 0, filt.kind, block,
               use_kernel)

        def make():
            def run(q, filt):
                gt = exact_filtered_knn(idx.xb, idx.attr, q, filt, k=k,
                                        block=block, use_kernel=use_kernel)
                B = q.shape[0]
                prim = torch.where(gt.ids >= 0, 0.0, INF)
                zeros = torch.zeros((B,), dtype=torch.int32, device=q.device)
                return SearchResult(gt.ids, prim, gt.d2,
                                    torch.zeros((B, 0), dtype=torch.int32,
                                                device=q.device),
                                    zeros, gt.n_dist)
            return run
        return self.run(key, make, queries, filt)

    # -- postfilter route (ls-wide unfiltered beam + filter) ---------------
    def postfilter(self, queries, filt, *, k: int, ls: int,
                   max_iters: int) -> SearchResult:
        """Unfiltered traversal keeping the ls-beam, then the k best
        filter-passing survivors. n_dist counts the traversal's distance
        computations plus the filter evaluations on the surviving beam."""
        idx = self.index
        key = ("postfilter", "default", "f32", k, ls, max_iters, filt.kind)

        def make():
            def run(q, filt):
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

