"""Per-query route dispatch: group-gather, execute each route, scatter back
(counterpart of ``repro.serve.dispatch``).

  1. ``planner.plan_per_query`` bands the [B] selectivity vector into route
     groups (original-batch positions, ascending within a group);
  2. :func:`dispatch_per_query` gathers each group's queries AND filter
     lanes (``FilterBatch.take``) into a contiguous sub-batch and runs it
     through its executor route;
  3. :func:`regroup` scatters the per-group ``SearchResult``s back into
     original query order with one inverse-permutation gather per field.

A SearchResult's ``vlog`` may be any width (the prefilter scan emits
``[B, 0]``); groups are -1 padded to the widest before the scatter.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from ..core.beam_search import SearchResult
from ..core.distances import lex_sort
from .planner import PerQueryPlan

__all__ = ["dispatch_per_query", "fold_topk", "merge_topk", "regroup",
           "route_descriptor", "run_route"]


def route_descriptor(route: str, layout: str = "default",
                     dtype: str = "f32") -> str:
    """The realized-route name: ``graph[fused,f32]`` for a graph route off
    the defaults, else the band name."""
    if route == "graph" and (layout != "default" or dtype != "f32"):
        return f"graph[{layout},{dtype}]"
    return route


def run_route(executor, route: str, queries, filt, *, k: int,
              ls: int, max_iters: int, layout: str = "default",
              dtype: str = "f32", introspect: bool = False):
    """Execute one executor route by name. ``layout``/``dtype`` select the
    graph route's serving variant; the scan and postfilter ignore them.

    ``introspect=True`` returns ``(result, stats)``: the graph route's
    per-query ``TraversalStats``, None on the scan and postfilter routes.
    """
    if route == "prefilter":
        res = executor.prefilter(queries, filt, k=k)
        return (res, None) if introspect else res
    if route == "graph":
        return executor.graph(queries, filt, k=k, ls=ls,
                              max_iters=max_iters, layout=layout,
                              dtype=dtype, introspect=introspect)
    if route == "postfilter":
        res = executor.postfilter(queries, filt, k=k, ls=ls,
                                  max_iters=max_iters)
        return (res, None) if introspect else res
    raise ValueError(f"unknown route {route!r}")


def merge_topk(base: SearchResult, extra: SearchResult, *,
               k: int) -> SearchResult:
    """Exact per-query merge of two top-k lists over disjoint id segments:
    one stable (primary, secondary) sort of the concatenation, ties
    resolving to ``base``. ``n_expanded`` and ``n_dist`` sum."""
    prim, sec, ids = lex_sort(torch.cat([base.primary, extra.primary], 1),
                              torch.cat([base.secondary, extra.secondary], 1),
                              torch.cat([base.ids, extra.ids], 1))
    return SearchResult(ids[:, :k], prim[:, :k], sec[:, :k], base.vlog,
                        base.n_expanded + extra.n_expanded,
                        base.n_dist + extra.n_dist)


def fold_topk(parts, *, k: int) -> SearchResult:
    """N-way :func:`merge_topk` fold over per-segment results, in segment
    order: ties on the (primary, secondary) key resolve to the lowest
    segment, and within it the lowest id, as one scan over the
    concatenated database would."""
    if not parts:
        raise ValueError("fold_topk needs at least one part")
    out = parts[0]
    for p in parts[1:]:
        out = merge_topk(out, p, k=k)
    return out


def regroup(parts, groups, batch: int) -> SearchResult:
    """Scatter per-group SearchResults back into original query order.
    ``parts[i]`` holds the results for original positions
    ``groups[i].ids``."""
    width = max(int(r.vlog.shape[1]) for r in parts)
    parts = [r._replace(vlog=torch.nn.functional.pad(
        r.vlog, (0, width - r.vlog.shape[1]), value=-1))
        if r.vlog.shape[1] != width else r for r in parts]
    order = np.concatenate([g.ids for g in groups])
    inv = np.empty(batch, np.int64)
    inv[order] = np.arange(batch)
    inv = torch.as_tensor(inv, device=parts[0].ids.device)
    return SearchResult(*(torch.cat([getattr(r, f) for r in parts])[inv]
                          for f in SearchResult._fields))


def _span(spans, name: str, **args):
    """``spans.span(...)`` when a recorder is given, else a no-op (any
    object with a ``span(name, **args)`` context manager works)."""
    if spans is None:
        return nullcontext()
    return spans.span(name, **args)


def dispatch_per_query(executor, queries, filt, pq: PerQueryPlan, *,
                       k: int, ls: int, max_iters: int,
                       layout: str = "default", dtype: str = "f32",
                       on_group=None, introspect: bool = False,
                       spans=None) -> SearchResult:
    """Run each route group through its executor route; regroup per query.

    ``on_group(group, result, stats, wall_seconds)``, when given, is
    called after each group's route has finished on the device (the
    dispatcher waits for it), with the host wall time of that group;
    ``stats`` is the graph route's ``TraversalStats`` when
    ``introspect=True``, else None. ``spans`` (a ``repro_torch.obs``
    ``SpanRecorder``) times the gather, execute and scatter stages; each
    group's ``execute:<route>`` span waits for the device, so its time is
    the group's. With neither (the default), nothing waits.
    """
    q = queries
    wait = on_group is not None or spans is not None

    def _run(group, q_g, f_g):
        with _span(spans, f"execute:{group.route}",
                   queries=int(q_g.shape[0])):
            t0 = time.perf_counter()
            out = run_route(executor, group.route, q_g, f_g, k=k, ls=ls,
                            max_iters=max_iters, layout=layout, dtype=dtype,
                            introspect=introspect)
            res, stats = out if introspect else (out, None)
            if wait and res.ids.is_cuda:
                torch.cuda.synchronize(res.ids.device)
            if on_group is not None:
                on_group(group, res, stats, time.perf_counter() - t0)
        return res

    if len(pq.groups) == 1:      # no split -> no gather/scatter round-trip
        return _run(pq.groups[0], q, filt)
    parts = []
    for g in pq.groups:
        with _span(spans, f"gather:{g.route}", queries=int(g.ids.size)):
            ids = torch.as_tensor(g.ids, dtype=torch.int64, device=q.device)
            q_g, f_g = q[ids], filt.take(g.ids)
        parts.append(_run(g, q_g, f_g))
    with _span(spans, "scatter", batch=int(q.shape[0])):
        return regroup(parts, pq.groups, q.shape[0])
