"""Selectivity-adaptive query planner (counterpart of
``repro.serve.planner``).

A sampled ``matches()`` probe estimates each query's filter selectivity and
routes it to one of the executor's three routes:

    sel <= prefilter_max_sel   -> "prefilter"   (masked exact scan)
    sel >= postfilter_min_sel  -> "postfilter"  (unfiltered + oversample)
    otherwise                  -> "graph"       (JAG traversal)

:func:`plan` picks one route for the batch from the median estimate;
:func:`plan_per_query` bands each query and groups queries by route. A
compound FilterExpr is probed as a whole tree, so the estimate is the joint
selectivity. The prefilter route asks :func:`reorder_clauses` for the
short-circuit-optimal clause order, from the per-leaf boolean sample
vectors of :func:`leaf_validity`. The sample rows are drawn with numpy, as
the reference draws them, so both packages probe the same rows.

When the index carries a calibrated cost model
(``JAGIndex.attach_cost_model``), both planners take a ``router``
(``cost.CostModelRouter``, built per call by ``Executor.cost_router``) and
each route is the argmin of predicted cost instead of the threshold
ladder; the plan then carries the predictions (``costs``, ``cost_metric``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.filters import (And, AttrTable, FilterBatch, FilterExpr, Leaf,
                            Not, Or, broadcast_rows, describe, match_rate,
                            matches, matches_sampled)

ROUTES = ("prefilter", "graph", "postfilter")


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    n_samples: int = 1024          # attr rows probed per selectivity estimate
    prefilter_max_sel: float = 0.02
    postfilter_min_sel: float = 0.75
    seed: int = 0                  # sample draw (deterministic per planner)

    def __post_init__(self):
        # values past 1.0 are legal on purpose: prefilter_max_sel=1.1 (with
        # postfilter_min_sel above it) forces the exact scan everywhere
        if self.n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, "
                             f"got {self.n_samples}")
        if self.prefilter_max_sel < 0.0:
            raise ValueError(f"prefilter_max_sel must be >= 0, "
                             f"got {self.prefilter_max_sel}")
        if self.prefilter_max_sel >= self.postfilter_min_sel:
            raise ValueError(
                f"inverted thresholds: prefilter_max_sel "
                f"{self.prefilter_max_sel} >= postfilter_min_sel "
                f"{self.postfilter_min_sel}")


class Plan(NamedTuple):
    """A whole-batch routing decision."""
    route: str                 # one of ROUTES
    selectivity: np.ndarray    # f32 [B] per-query estimates
    batch_selectivity: float   # the median driving the route choice
    n_sampled: int             # probe size actually used (== n for exact)
    # predicted cost/query per route at the batch median when a cost-model
    # router made the decision (in cost_metric units); None under the
    # static thresholds
    costs: Optional[Dict[str, float]] = None
    cost_metric: Optional[str] = None    # "us" | "n_dist" | None (static)
    realized: str | None = None  # route variant that executed


class GroupPlan(NamedTuple):
    """One route group of a per-query plan."""
    route: str                 # one of ROUTES
    ids: np.ndarray            # int32 [G] positions in the original batch
    selectivity: float         # median estimate within the group


class PerQueryPlan(NamedTuple):
    """Per-query routing decisions for one batch; ``groups`` lists the
    non-empty route groups in ROUTES order."""
    routes: Tuple[str, ...]    # per-query route, len B
    selectivity: np.ndarray    # f32 [B] per-query estimates
    groups: Tuple[GroupPlan, ...]
    n_sampled: int
    costs: Optional[Dict[str, float]] = None   # as in Plan
    cost_metric: Optional[str] = None
    realized: Tuple[str, ...] | None = None  # per-query executed variant

    @property
    def route(self) -> str:
        """The single route when the batch didn't split, else "mixed"."""
        return self.groups[0].route if len(self.groups) == 1 else "mixed"

    @property
    def batch_selectivity(self) -> float:
        return float(np.median(self.selectivity))


def sample_ids(n: int, n_samples: int, seed: int = 0,
               device=None) -> torch.Tensor:
    """Deterministic sample of attr-table rows; exact (arange) if it fits.
    Drawn with numpy's generator, the reference's draw."""
    if n_samples >= n:
        ids = np.arange(n, dtype=np.int32)
    else:
        rng = np.random.default_rng(seed)
        ids = rng.choice(n, n_samples, replace=False).astype(np.int32)
    return torch.as_tensor(ids, device=device)


def estimate_selectivity(filt, table: AttrTable,
                         ids: torch.Tensor) -> torch.Tensor:
    """Per-query selectivity estimate f32[B] from a sampled matches()
    probe; compound trees are evaluated whole (joint estimate)."""
    if isinstance(filt, FilterBatch):
        ok = matches_sampled(filt, table, ids)
    else:
        ok = matches(filt, broadcast_rows(table, ids))
    return match_rate(ok)


def leaf_selectivities(filt, table: AttrTable,
                       ids: torch.Tensor) -> torch.Tensor:
    """Per-leaf sampled selectivities f32[L, B], leaves in DFS order (the
    marginal summaries benchmarks and explain-style logs report)."""
    attrs = broadcast_rows(table, ids)
    leaves = filt.leaves() if isinstance(filt, FilterExpr) else [filt]
    return torch.stack([match_rate(matches(f, attrs)) for f in leaves])


def leaf_validity(filt, table: AttrTable, ids: torch.Tensor) -> torch.Tensor:
    """Per-leaf boolean validity bool[L, B, S] on the probe rows (DFS
    order), the raw material of :func:`reorder_clauses`."""
    attrs = broadcast_rows(table, ids)
    leaves = filt.leaves() if isinstance(filt, FilterExpr) else [filt]
    return torch.stack([matches(f, attrs) for f in leaves])


def _leaf_values(leaf_sels):
    """Scalars (independence mode) or per-leaf boolean arrays (joint mode);
    a mixed list degrades every vector to its mean."""
    out = [np.asarray(v) for v in leaf_sels]
    if any(a.ndim == 0 for a in out):
        return [float(a) if a.ndim == 0 else float(np.mean(a)) for a in out]
    return [a.astype(bool) for a in out]


def _frac(v) -> float:
    return float(np.mean(v)) if isinstance(v, np.ndarray) else float(v)


def _vand(a, b):
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a & b
    return a * b


def _vnot(v):
    return ~v if isinstance(v, np.ndarray) else 1.0 - v


def _vtrue(like):
    return (np.ones_like(like, dtype=bool)
            if isinstance(like, np.ndarray) else 1.0)


def _order_clauses(filt, leaf_iter, reorder: bool):
    """Recursive (expr, validity, expected_evals_per_point); each next
    clause is the one with the best cost per unit of conditional filtering
    power given the clauses already placed."""
    if isinstance(filt, FilterBatch):
        return filt, next(leaf_iter), 1.0
    if isinstance(filt, Leaf):
        f, v, c = _order_clauses(filt.filt, leaf_iter, reorder)
        return Leaf(f), v, c
    if isinstance(filt, Not):
        ch, v, c = _order_clauses(filt.child, leaf_iter, reorder)
        return Not(ch), _vnot(v), c
    if isinstance(filt, (And, Or)):
        kids = [_order_clauses(c, leaf_iter, reorder)
                for c in filt.children]
        is_and = isinstance(filt, And)
        if reorder:
            ordered, live = [], _vtrue(kids[0][1])
            while kids:
                lm = _frac(live)

                def rank(t):
                    inter = _frac(_vand(live, t[1]))
                    power = (lm - inter) if is_and else inter
                    return t[2] / max(power, 1e-9)

                i = min(range(len(kids)), key=lambda j: rank(kids[j]))
                t = kids.pop(i)
                ordered.append(t)
                live = _vand(live, t[1] if is_and else _vnot(t[1]))
            kids = ordered
        live, cost = _vtrue(kids[0][1]), 0.0
        for _, v, c in kids:
            cost += _frac(live) * c
            live = _vand(live, v if is_and else _vnot(v))
        val = live if is_and else _vnot(live)
        node = (And if is_and else Or)(*[k[0] for k in kids])
        return node, val, cost
    raise TypeError(f"not a filter: {type(filt)!r}")


def reorder_clauses(filt, leaf_sels):
    """Short-circuit-optimal clause order, cheapest most-selective first.
    ``leaf_sels``: one value per leaf in DFS order, scalar selectivities or
    per-leaf boolean sample vectors. Result-identical: only ``n_feval``
    changes. Atomic filters pass through."""
    if not isinstance(filt, FilterExpr):
        return filt
    return _order_clauses(filt, iter(_leaf_values(leaf_sels)), True)[0]


def clause_eval_cost(filt, leaf_sels) -> float:
    """Expected short-circuit leaf evals per scanned point, given the
    tree's current clause order and per-leaf selectivities or validity
    vectors (DFS order; scalar = independence, boolean vector = joint)."""
    return _order_clauses(filt, iter(_leaf_values(leaf_sels)), False)[2]


def choose_route(sel: float, cfg: PlannerConfig) -> str:
    """Threshold router over one selectivity scalar (the fallback when no
    cost model is attached)."""
    if sel <= cfg.prefilter_max_sel:
        return "prefilter"
    if sel >= cfg.postfilter_min_sel:
        return "postfilter"
    return "graph"


def _route_of(sel: float, cfg: PlannerConfig, router) -> str:
    """One query's route: the cost-model argmin when a router is given,
    else the static threshold ladder."""
    return router.route(sel) if router is not None else choose_route(sel,
                                                                     cfg)


def _estimate(filt, table: AttrTable, cfg: PlannerConfig,
              executor) -> Tuple[np.ndarray, int]:
    """Shared probe: host f32[B] estimates + the probe size used."""
    if executor is not None:
        ids = executor.sample_ids(table.n, cfg.n_samples, cfg.seed)
        key = ("estimate", "default", "f32", 0, 0, 0, filt.kind,
               int(ids.shape[0]))
        est = executor.run(key, lambda: estimate_selectivity,
                           filt, table, ids)
    else:
        ids = sample_ids(table.n, cfg.n_samples, cfg.seed, table.device)
        est = estimate_selectivity(filt, table, ids)
    return est.cpu().numpy().astype(np.float32), int(ids.shape[0])


def plan(filt, table: AttrTable, cfg: PlannerConfig = PlannerConfig(),
         executor=None, router=None) -> Plan:
    """Estimate the batch's selectivity and pick ONE route for all
    queries (by the median estimate); with a ``router``, the argmin of
    predicted cost at the median, reported in ``Plan.costs``."""
    sel, n_sampled = _estimate(filt, table, cfg, executor)
    batch_sel = float(np.median(sel))
    if router is None:
        return Plan(_route_of(batch_sel, cfg, None), sel, batch_sel,
                    n_sampled)
    return Plan(router.route(batch_sel), sel, batch_sel, n_sampled,
                router.costs(batch_sel), router.metric)


def plan_per_query(filt, table: AttrTable,
                   cfg: PlannerConfig = PlannerConfig(),
                   executor=None, router=None) -> PerQueryPlan:
    """Band the per-query selectivity vector into route groups (positions
    ascending within a group, so gather/scatter is a stable permutation);
    with a ``router``, each query's band is its predicted-cost argmin."""
    sel, n_sampled = _estimate(filt, table, cfg, executor)
    routes = tuple(_route_of(float(s), cfg, router) for s in sel)
    routes_arr = np.asarray(routes)
    groups = []
    for route in ROUTES:
        members = np.flatnonzero(routes_arr == route)
        if members.size:
            groups.append(GroupPlan(route, members.astype(np.int32),
                                    float(np.median(sel[members]))))
    if router is None:
        return PerQueryPlan(routes, sel, tuple(groups), n_sampled)
    return PerQueryPlan(routes, sel, tuple(groups), n_sampled,
                        router.costs(float(np.median(sel))), router.metric)


def _executed_note(p) -> str:
    """Realized-route summary when it differs from the planned band names;
    empty when the plan never ran or ran exactly as planned."""
    realized = getattr(p, "realized", None)
    if realized is None:
        return ""
    if isinstance(realized, str):
        return "" if realized == p.route else realized
    if tuple(realized) == tuple(getattr(p, "routes", ())):
        return ""
    counts: Dict[str, int] = {}
    for name in realized:
        counts[name] = counts.get(name, 0) + 1
    return " ".join(f"{name}:{c}" for name, c in counts.items())


def explain(p, cfg: PlannerConfig = PlannerConfig(), filt=None) -> str:
    """One-line routing rationale, the reference's text. ``filt`` prepends
    the filter expression; an ``executed[...]`` summary follows when the
    realized routes differ from the planned band names."""
    head = f"route={p.route} sel~{p.batch_selectivity:.4f}"
    if filt is not None:
        head = f"filter={describe(filt)} {head}"
    if isinstance(p, PerQueryPlan):
        split = " ".join(f"{g.route}:{g.ids.size}" for g in p.groups)
        head += f" [{split}]"
    executed = _executed_note(p)
    if executed:
        head += f" executed[{executed}]"
    if p.costs is not None:
        unit = {"us": "us", "n_dist": "DC"}.get(p.cost_metric,
                                                p.cost_metric or "")
        pred = " ".join(f"{r}={c:.1f}{unit}" for r, c in p.costs.items())
        return f"{head} (n_sampled={p.n_sampled}, cost-model argmin: {pred})"
    lo, hi = cfg.prefilter_max_sel, cfg.postfilter_min_sel
    return (f"{head} (n_sampled={p.n_sampled}, thresholds: "
            f"prefilter<={lo}, postfilter>={hi})")
