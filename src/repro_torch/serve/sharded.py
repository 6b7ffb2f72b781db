"""Sharded serving: per-shard routes and the exact cross-shard top-k merge
(counterpart of ``repro.serve.sharded``).

The database (vectors, row norms, attribute table, graph, entry seeds) is
sharded row-wise over a mesh: a list of S devices, shard s on ``mesh[s]``
(``repro_torch.distributed.sharding``; a device may repeat, so four shards
can share one card). Each shard is a self-contained JAG over N_loc = N / S
rows. One process drives every shard, as the reference's single
``shard_map`` program does, and every executor route runs:

  1. on each shard, over its own rows: the prefilter scan, the beam-search
     graph traversal from the shard's own entry seeds, the postfilter
     oversampled traversal;
  2. shard-local ids are globalized onto disjoint segments (``+ s * N_loc``,
     shard s owns [s*N_loc, (s+1)*N_loc));
  3. each shard's result is packed into one ``[B, 3k + 2]`` int32 payload
     and moved once to the lead device ``mesh[0]`` (the all-gather with one
     consumer, counted in :data:`GATHERS`), where ``serve.dispatch.
     fold_topk`` folds the shards IN SHARD ORDER into the exact global
     top-k. The bytes moved scale with B*k, independent of N.

Exact-merge semantics: ``merge_topk`` sorts stably on the lexicographic
(primary, secondary) key with the lower segment as the tie-winning base,
so the fold resolves equal keys to the lowest global id, as one scan over
the concatenated database does. The exact routes are therefore identical
to an index over the union of the shards' rows (on the card bit for bit:
the scan tile's d2 does not depend on the blocking); the graph route
traverses per-shard sub-graphs, so it matches a single index exactly at
S = 1 and at recall parity for S > 1.

:class:`ShardedJAGIndex` serves behind the same ``search_auto(queries,
filt, k, ls)`` surface as ``JAGIndex``: it reuses the single-device
planner verbatim (the selectivity probe runs on the replicated union
attribute table on ``mesh[0]``), and :meth:`ShardedExecutor.cost_router`
predicts at the per-shard shape (n = N_loc), so an
``InterpolatedCostModel`` over shard-shaped grids routes a new shard count
without a calibration of its own.

Telemetry across shards: ``n_expanded``/``n_dist`` sum over shards;
``vlog`` is the width-0 ``[B, 0]`` (per-shard logs are shard-local and
id-ambiguous after globalization). The scan route's single-device vlog is
``[B, 0]`` too, so forced-prefilter results equal the union index's on
every field.

Not yet sharded (as in the reference): streaming deltas, the int8 and
fused serving variants, traversal introspection, and cross-host dispatch
(the multi-process counterpart of one controller per host).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core.beam_search import SearchResult, greedy_search
from ..core.distances import INF, lex_sort, query_key_fn, unfiltered_key_fn
from ..core.filters import (AttrTable, FilterBatch, FilterExpr, as_filter,
                            matches, n_leaves)
from ..core.jag import JAGConfig, JAGIndex
from ..distributed.sharding import as_mesh, put_db_sharded, serve_mesh
from .dispatch import fold_topk
from .executor import Executor

# packed per-shard results moved to the lead device: one transfer per
# shard per route call, of B * (3k + 2) * 4 bytes each
GATHERS = {"transfers": 0, "bytes": 0}


def reset_gathers() -> None:
    GATHERS["transfers"] = 0
    GATHERS["bytes"] = 0


def _merge_across_shards(parts: Sequence[SearchResult], *, k: int,
                         device) -> SearchResult:
    """Fold the shards' globalized results into the exact top-k on
    ``device``, in shard order (ties go to the lowest segment, as in a
    union scan).

    Each shard's five live fields (ids, primary, secondary [B, k];
    n_expanded, n_dist [B]; vlog is dropped, see the module docstring) are
    concatenated into one int32 ``[B, 3k + 2]`` payload, the float fields
    bitcast (exact for INF and NaN patterns), so each shard sends one
    transfer of B*(3k+2)*4 bytes per route call.
    """
    B = int(parts[0].ids.shape[0])
    gathered = []
    for res in parts:
        packed = _send(torch.cat(
            [res.ids, res.primary.view(torch.int32),
             res.secondary.view(torch.int32), res.n_expanded[:, None],
             res.n_dist[:, None]], dim=1), device)
        gathered.append(SearchResult(
            packed[:, :k], packed[:, k:2 * k].view(torch.float32),
            packed[:, 2 * k:3 * k].view(torch.float32),
            torch.zeros((B, 0), dtype=torch.int32, device=device),
            packed[:, 3 * k], packed[:, 3 * k + 1]))
    return fold_topk(gathered, k=k)


def _send(packed: torch.Tensor, device) -> torch.Tensor:
    """One shard's packed payload on the lead ``device``, counted in
    ``GATHERS`` (``launch.trace_stats`` records it as a packed gather)."""
    out = packed.to(device)
    GATHERS["transfers"] += 1
    GATHERS["bytes"] += out.numel() * out.element_size()
    return out


def _to_shard(queries: torch.Tensor, filt, device):
    """The query batch and its filter on a shard's ``device``
    (``launch.trace_stats`` records it as a broadcast)."""
    return queries.to(device), _filter_to(filt, device)


def _filter_to(filt, device):
    """The filter (atomic, compound or None) with its tensors on
    ``device``."""
    if filt is None:
        return None
    if isinstance(filt, FilterExpr):
        return filt._map_leaves(lambda f: _filter_to(f, device))
    if all(v.device == device for v in filt.data.values()):
        return filt
    return FilterBatch(filt.kind, {k: v.to(device)
                                   for k, v in filt.data.items()},
                       filt.n_bits)


class ShardedExecutor(Executor):
    """The executor's route and cache surface over per-shard tensors.

    The cache, epoch plumbing, planner sample buffers and compound-clause
    reordering are inherited unchanged (they work on the replicated union
    attribute table); the four base routes are overridden to run each
    shard and merge. One cache key per route serves every shard: the
    route closures take a shard's tensors as arguments."""

    # -- routing shape: predict at the per-shard grid ----------------------
    def cost_router(self, *, k: int, ls: int, filt=None):
        """Per-shard cost routing: every shard runs the route over its own
        N_loc rows (the merge adds a B*k sort), so predictions use
        n = N_loc, the shard-shape grid an ``InterpolatedCostModel``
        interpolates over, not the union row count."""
        model = getattr(self.index, "cost_model", None)
        if model is None:
            return None
        from ..cost.model import BASE_ROUTES, CostModelRouter
        metric = getattr(self.index, "cost_metric", "us")
        if not model.covers(BASE_ROUTES, metric):
            return None
        idx = self.index
        clauses = 1 if filt is None else n_leaves(filt)
        return CostModelRouter(model, n=idx.n_loc, d=idx.d, k=k, ls=ls,
                               delta_n=0, metric=metric, n_leaves=clauses)

    # -- per-shard route runs ------------------------------------------------
    def _sharded(self, key, make, queries, filt, *, k: int) -> SearchResult:
        """Run the closure cached under ``key`` on every shard as
        ``run(graph, xb, xb_norm, attr, entry, q, filt)`` (ids shard-local),
        globalize the ids onto the shard's segment and merge."""
        idx = self.index
        parts = []
        for s, dev in enumerate(idx.mesh):
            res = self.run(key, make, idx.graph[s], idx.xb[s],
                           idx.xb_norm[s], idx.shard_attr(s), idx.entry[s],
                           *_to_shard(queries, filt, dev))
            gids = torch.where(res.ids >= 0, res.ids + s * idx.n_loc, -1)
            parts.append(res._replace(ids=gids))
        return _merge_across_shards(parts, k=k, device=idx.device)

    def prefilter(self, queries, filt, *, k: int, block: int = 4096,
                  use_kernel: Optional[bool] = None) -> SearchResult:
        """Sharded masked exact scan: each shard scans its rows through
        the executor's scan (ids offset onto its segment); the merge is
        exact, equal to the union index's scan."""
        if use_kernel is None:
            use_kernel = self.use_kernel
        filt = self._reorder_compound(filt)
        idx = self.index
        key = ("prefilter", "default", "f32", k, 0, 0, filt.kind, block,
               use_kernel)
        parts = [self._scan(key, idx.xb[s], idx.shard_attr(s),
                            *_to_shard(queries, filt, dev), k=k,
                            block=block, use_kernel=use_kernel,
                            offset=s * idx.n_loc)
                 for s, dev in enumerate(idx.mesh)]
        return _merge_across_shards(parts, k=k, device=idx.device)

    def graph(self, queries, filt, *, k: int, ls: int, max_iters: int,
              layout: str = "default", dtype: str = "f32",
              introspect: bool = False) -> SearchResult:
        """Sharded JAG traversal: each shard walks its own sub-graph from
        its own entry seeds; the exact merge keeps the k best of the S
        shard beams. Only the default f32 variant is sharded."""
        if introspect:
            raise NotImplementedError(
                "traversal introspection is single-device only — the "
                "cross-shard merge would need per-shard stat reduction "
                "(recorded follow-on); detach Telemetry(introspect=True) "
                "before serving sharded")
        if (layout, dtype) != ("default", "f32"):
            raise NotImplementedError(
                f"sharded graph route serves layout='default', dtype='f32' "
                f"only (got {layout!r}, {dtype!r}) — int8/fused sharding "
                f"is a recorded follow-on")
        key = ("graph", layout, dtype, k, ls, max_iters, filt.kind)

        def make():
            def run(graph, xb, xb_norm, attr, entry, q, f):
                return greedy_search(graph, xb, xb_norm, attr, q, entry,
                                     query_key_fn(f), ls=ls, k=k,
                                     max_iters=max_iters)
            return run
        return self._sharded(key, make, queries, filt, k=k)

    def unfiltered(self, queries, *, k: int, ls: int,
                   max_iters: int) -> SearchResult:
        """Sharded pure vector-distance traversal; the per-shard beams
        merge as the graph route's do."""
        key = ("unfiltered", "default", "f32", k, ls, max_iters, None)

        def make():
            def run(graph, xb, xb_norm, attr, entry, q, f):
                return greedy_search(graph, xb, xb_norm, attr, q, entry,
                                     unfiltered_key_fn(), ls=ls, k=k,
                                     max_iters=max_iters)
            return run
        return self._sharded(key, make, queries, None, k=k)

    def postfilter(self, queries, filt, *, k: int, ls: int,
                   max_iters: int) -> SearchResult:
        """Sharded post-filtering: each shard's unfiltered ls-beam is
        filtered against its own attribute rows, then merged."""
        key = ("postfilter", "default", "f32", k, ls, max_iters, filt.kind)

        def make():
            def run(graph, xb, xb_norm, attr, entry, q, f):
                res = greedy_search(graph, xb, xb_norm, attr, q, entry,
                                    unfiltered_key_fn(), ls=ls, k=ls,
                                    max_iters=max_iters)
                ids = res.ids
                ok = matches(f, attr.gather(ids.clamp_min(0))) & (ids >= 0)
                prim, sec, idsm = lex_sort(
                    torch.where(ok, 0.0, INF),
                    torch.where(ok, res.secondary, INF),
                    torch.where(ok, ids, -1))
                n_dist = res.n_dist + torch.sum(ids >= 0, dim=1,
                                                dtype=torch.int32)
                return SearchResult(idsm[:, :k], prim[:, :k], sec[:, :k],
                                    res.vlog, res.n_expanded, n_dist)
            return run
        return self._sharded(key, make, queries, filt, k=k)


class ShardedJAGIndex:
    """Row-sharded JAG behind the single-device ``search_auto`` surface.

    Holds the per-shard state as tuples of S tensors, element s on
    ``mesh[s]``:

        graph     int32 (S x [N_loc, R])  shard-local neighbour ids
        xb        f32   (S x [N_loc, d])
        xb_norm   f32   (S x [N_loc])
        attr_data       {name: S x [N_loc, ...]}
        entry     int32 (S x [E])         per-shard entry seeds

    plus the replicated union :class:`AttrTable` (``.attr``, on the lead
    device ``mesh[0]``) that the planner probes, so routing sees the
    selectivity estimates of a single index over the same rows. Build with
    :meth:`build` (splits rows contiguously, builds one sub-graph per
    shard on its device) or :meth:`from_shards` (adopts built per-shard
    indexes); ``JAGIndex.shard(n_shards)`` is the one-call migration.
    """

    epoch: int = 0        # frozen, like JAGIndex: streaming is a follow-on

    def __init__(self, *, mesh, graph, xb, xb_norm, attr_data, entry,
                 attr: AttrTable, cfg: JAGConfig):
        self.mesh = as_mesh(mesh)
        self.n_shards = len(self.mesh)
        if len(graph) != self.n_shards:
            raise ValueError(
                f"stacked arrays carry {len(graph)} shards but the mesh "
                f"is {self.n_shards}-way")
        placed = put_db_sharded(dict(graph=graph, xb=xb, xb_norm=xb_norm,
                                     attr_data=attr_data, entry=entry),
                                self.mesh)
        self.graph = placed["graph"]
        self.xb = placed["xb"]
        self.xb_norm = placed["xb_norm"]
        self.attr_data = placed["attr_data"]
        self.entry = placed["entry"]
        self.attr = attr.to(self.mesh[0])         # replicated union table
        self.n_loc = int(self.xb[0].shape[0])
        self.d = int(self.xb[0].shape[1])
        self.cfg = cfg
        self._executor = None
        self.cost_model = None
        self.cost_metric = "us"
        self.telemetry = None
        if attr.n != self.n_shards * self.n_loc:
            raise ValueError(
                f"union attr table has {attr.n} rows, shards carry "
                f"{self.n_shards} x {self.n_loc}")

    @property
    def device(self) -> torch.device:
        """The lead device: queries, the planner and the merge live here."""
        return self.mesh[0]

    def shard_attr(self, s: int) -> AttrTable:
        """Shard ``s``'s attribute table, on its device."""
        return AttrTable(self.attr.kind,
                         {k: v[s] for k, v in self.attr_data.items()},
                         n_bits=self.attr.n_bits)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_shards(cls, shards: Sequence[JAGIndex],
                    mesh=None) -> "ShardedJAGIndex":
        """Adopt per-shard JAGIndexes (equal row counts and attr schemas);
        shard i serves global ids [i*N_loc, (i+1)*N_loc). ``mesh``
        defaults to ``serve_mesh(len(shards))``."""
        if not shards:
            raise ValueError("need at least one shard")
        n_loc = int(shards[0].xb.shape[0])
        kind, n_bits = shards[0].attr.kind, shards[0].attr.n_bits
        for s in shards[1:]:
            if int(s.xb.shape[0]) != n_loc:
                raise ValueError("all shards must hold the same row count "
                                 f"({n_loc} != {int(s.xb.shape[0])})")
            if s.attr.kind != kind or s.attr.n_bits != n_bits:
                raise ValueError("all shards must share one attr schema")
        mesh = as_mesh(mesh if mesh is not None
                       else serve_mesh(len(shards)))
        keys = shards[0].attr.data
        union = AttrTable(kind, {
            k: (keys[k].to(mesh[0]) if k == "bit_weights" else
                torch.cat([s.attr.data[k].to(mesh[0]) for s in shards]))
            for k in keys}, n_bits=n_bits)
        return cls(
            mesh=mesh,
            graph=[s.graph for s in shards], xb=[s.xb for s in shards],
            xb_norm=[s.xb_norm for s in shards],
            attr_data={k: [s.attr.data[k] for s in shards] for k in keys},
            entry=[s.entry for s in shards], attr=union, cfg=shards[0].cfg)

    @classmethod
    def build(cls, xb, attr: AttrTable, cfg: JAGConfig = JAGConfig(),
              *, n_shards: Optional[int] = None, mesh=None,
              verbose: bool = False) -> "ShardedJAGIndex":
        """Split rows contiguously into S shards and build one sub-graph
        per shard on its device (shard-local entry seeds included). N must
        divide by S; ragged resharding waits with cross-host dispatch."""
        if mesh is None:
            if n_shards is None:
                raise ValueError("pass n_shards or a mesh")
            mesh = serve_mesh(int(n_shards))
        mesh = as_mesh(mesh)
        S = len(mesh)
        n = int(xb.shape[0])
        if n % S != 0:
            raise ValueError(f"N={n} rows do not split evenly into "
                             f"{S} shards")
        n_loc = n // S
        shards: List[JAGIndex] = []
        for s, dev in enumerate(mesh):
            lo, hi = s * n_loc, (s + 1) * n_loc
            sub = AttrTable(attr.kind,
                            {k: (v if k == "bit_weights" else v[lo:hi])
                             for k, v in attr.data.items()},
                            n_bits=attr.n_bits)
            shards.append(JAGIndex.build(xb[lo:hi], sub, cfg,
                                         verbose=verbose, device=dev))
        return cls.from_shards(shards, mesh=mesh)

    # -- serving (the JAGIndex surface) ------------------------------------
    @property
    def executor(self) -> ShardedExecutor:
        if self._executor is None:
            self._executor = ShardedExecutor(self)
        return self._executor

    # search_auto, attach_cost_model and attach_telemetry run the single-
    # device implementations verbatim: they only touch self.executor,
    # self.attr, self.cost_*, self.telemetry and self._q, so the sharded
    # index is a drop-in behind the public surface. Telemetry records the
    # per-shard view (n = n_loc, shard = [S, n_loc]).
    search_auto = JAGIndex.search_auto
    attach_cost_model = JAGIndex.attach_cost_model
    attach_telemetry = JAGIndex.attach_telemetry
    _q = JAGIndex._q

    def search(self, queries, filt, k: int = 10, ls: int = 64,
               max_iters: int = 0) -> SearchResult:
        """Sharded filtered traversal (the graph route, default layout)."""
        return self.executor.graph(self._q(queries), as_filter(filt), k=k,
                                   ls=ls, max_iters=max_iters or 2 * ls)


def shard_index(index: JAGIndex, n_shards: int,
                mesh=None) -> ShardedJAGIndex:
    """Re-shard a built single-device index across ``n_shards`` devices
    (or the device list ``mesh``).

    Sub-graphs are REBUILT per shard from the index's rows and config: a
    built graph's edges cross any row split, so slicing the adjacency
    would orphan every cross-shard edge; an honest reshard is a rebuild.
    """
    return ShardedJAGIndex.build(
        index.xb, index.attr, index.cfg,
        n_shards=None if mesh is not None else n_shards, mesh=mesh)
