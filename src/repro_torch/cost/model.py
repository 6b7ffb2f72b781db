"""Fitted analytic cost model + the argmin router it drives (a copy of
``repro.cost.model``).

Each executor route's cost is modeled log-linearly in route-specific
feature terms (all positive, so the model is multiplicative and its
predictions can never go negative):

    log(cost) = w . phi(route, features)

    prefilter   ~ N*d            (block GEMM touches every row) x sel^c
    graph       ~ ls*d x sel^c x N^c   (iters grow as selectivity drops)
    postfilter  ~ ls*d x N^c x sel^c   (oversampled unfiltered beam)
    delta       ~ delta_n*d      (exact scan over the live segment)
    merge       ~ k              (one stable sort over 2k columns)
    compact     ~ delta_n x d    (batch-insert passes over delta ids;
                                  TOTAL us per compaction, not per query)

Fitting is plain per-route least squares on log(measured cost) over the
calibration grid (``calibrate.run_calibration``); a route with fewer
observations than coefficients stays uncalibrated and the model reports
``covers(...) == False`` for it, which makes the planner fall back to the
static thresholds — the principled degradation path.

``CostModelRouter`` is the serving-side integration: built per search call
by ``serve.Executor.cost_router`` with the live (n, d, k, ls, delta_n), it
predicts every base route's us/query — folding the constant delta-scan tax
(delta + merge) that a streaming index pays on EVERY route into each
prediction — and routes each query to the argmin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# routes the planner chooses between; delta/merge/compact are costs every
# choice shares (streaming) or one-off maintenance, never routing targets
BASE_ROUTES = ("prefilter", "graph", "postfilter")
ALL_ROUTES = BASE_ROUTES + ("delta", "merge", "compact")
METRICS = ("us", "n_dist")
_EPS = 1e-4                       # selectivity floor inside log terms

# ONE table defines each route's feature terms: (name, value-extractor over
# the clamped canonical features). phi() and feature_names() both derive
# from it, so the coefficient labels published in artifacts can never
# drift from the values actually fitted. compact is deliberately 2 terms
# so a minimal grid (two delta_n points at one d) fully determines it —
# compaction work is insert passes over delta rows, each ~ d-proportional.
_TERMS = {
    # n_clauses (compound-filter clause count) is appended LAST so legacy
    # 3-coefficient prefilter models stay valid: predict() zero-pads short
    # coefficient vectors, and log(n_clauses)=0 at the atomic default of 1,
    # so old models' predictions are bit-identical (append-only term
    # policy — new terms must default to a canonical value whose log is 0).
    "prefilter": (("log(n*d)", lambda c: c["n"] * c["d"]),
                  ("log(sel)", lambda c: c["sel"]),
                  ("log(n_clauses)", lambda c: c["n_clauses"])),
    "graph": (("log(ls*d)", lambda c: c["ls"] * c["d"]),
              ("log(sel)", lambda c: c["sel"]),
              ("log(n)", lambda c: c["n"])),
    "postfilter": (("log(ls*d)", lambda c: c["ls"] * c["d"]),
                   ("log(n)", lambda c: c["n"]),
                   ("log(sel)", lambda c: c["sel"])),
    "delta": (("log(delta_n*d)", lambda c: c["delta_n"] * c["d"]),),
    "merge": (("log(k)", lambda c: c["k"]),),
    "compact": (("log(delta_n*d)", lambda c: c["delta_n"] * c["d"]),),
}


def _canon(features: Dict[str, float]) -> Dict[str, float]:
    """Clamped canonical features: absent keys default to benign values
    (the delta/compact terms never need a selectivity) and every value is
    floored so the log terms stay finite."""
    f = features
    return dict(sel=min(max(float(f.get("sel", 1.0)), _EPS), 1.0),
                n=max(float(f.get("n", 1.0)), 1.0),
                d=max(float(f.get("d", 1.0)), 1.0),
                ls=max(float(f.get("ls", 64.0)), 1.0),
                k=max(float(f.get("k", 10.0)), 1.0),
                delta_n=max(float(f.get("delta_n", 0.0)), 1.0),
                n_clauses=max(float(f.get("n_clauses", 1.0)), 1.0))


def feature_names(route: str) -> Tuple[str, ...]:
    """The ordered feature-term names behind ``phi(route, ...)``."""
    if route not in _TERMS:
        raise ValueError(f"unknown route {route!r}")
    return ("1",) + tuple(name for name, _ in _TERMS[route])


def phi(route: str, features: Dict[str, float]) -> np.ndarray:
    """Route-specific log-feature vector for one observation."""
    if route not in _TERMS:
        raise ValueError(f"unknown route {route!r}")
    c = _canon(features)
    return np.asarray([1.0] + [math.log(fn(c)) for _, fn in _TERMS[route]],
                      np.float64)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One calibration measurement of one route.

    ``us`` is the median per-query wall time in microseconds for the query
    routes, and the TOTAL wall time for the one-off ``compact``;
    ``n_dist`` is the mean distance computations per query (0 where the
    metric has no meaning, e.g. compaction).
    """
    route: str
    features: Dict[str, float]
    us: float
    n_dist: float = 0.0


@dataclasses.dataclass
class CostModel:
    """Per-route fitted coefficients + provenance metadata.

    ``coef[route][metric]`` are the log-linear weights for
    ``phi(route, .)``; ``meta`` carries backend/dtype/layout (the registry
    key), the calibration batch size, and the grid; ``fit_stats[route]``
    records the on-grid relative prediction error so artifacts (and CI)
    can judge the fit without re-measuring.
    """
    coef: Dict[str, Dict[str, List[float]]]
    meta: Dict
    fit_stats: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def routes(self) -> Tuple[str, ...]:
        return tuple(self.coef)

    def covers(self, routes: Sequence[str], metric: str = "us") -> bool:
        """True when every requested route has fitted ``metric`` weights."""
        return all(r in self.coef and metric in self.coef[r]
                   for r in routes)

    def predict(self, route: str, features: Dict[str, float],
                metric: str = "us") -> float:
        """Predicted cost (always positive: exp of the fitted log-cost).

        Coefficient vectors shorter than the current feature table are
        zero-padded: feature terms are append-only and new terms log to 0
        at their canonical default, so a legacy model predicts exactly
        what it predicted when it was fitted.
        """
        w = np.asarray(self.coef[route][metric], np.float64)
        x = phi(route, features)
        if w.shape[0] < x.shape[0]:
            w = np.pad(w, (0, x.shape[0] - w.shape[0]))
        elif w.shape[0] > x.shape[0]:
            raise ValueError(
                f"{route}/{metric} has {w.shape[0]} coefficients but "
                f"phi() has {x.shape[0]} terms — model is from a newer "
                f"feature table")
        return float(math.exp(float(x @ w)))


@dataclasses.dataclass
class InterpolatedCostModel:
    """Cost predictions between per-shard calibrated (N, d) grids.

    Sharded serving changes the per-shard row count with the shard count
    (N_loc = N / S), and a dedicated calibration pass per shard count
    would make every resize an offline event. Instead the registry stores
    one :class:`CostModel` per calibrated per-shard grid (``meta
    ["shard_shape"] = [n, d]``) and this wrapper predicts at any fresh
    shard shape: pick the d-group with the nearest log-distance, evaluate
    the two n-bracketing grid models AT THEIR OWN grid n, and interpolate
    log-linearly in log n. Exact at the grid points (the bracketing
    weight degenerates to 0/1 and the grid model sees its own n) and
    monotone in n between them (a log-log line is monotone); outside the
    calibrated n span the nearest endpoint model extrapolates with the
    true n, i.e. its own fitted log(n) slope.

    Duck-typed to :class:`CostModel`'s ``covers``/``predict`` surface, so
    ``CostModelRouter`` and the planner take either interchangeably.
    """
    grids: List[CostModel]
    meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for m in self.grids:
            if "shard_shape" not in m.meta:
                raise ValueError("every grid model needs meta['shard_shape']"
                                 " = [n, d] — stamp it at calibration time")

    def routes(self) -> Tuple[str, ...]:
        common = set(self.grids[0].coef) if self.grids else set()
        for m in self.grids[1:]:
            common &= set(m.coef)
        return tuple(sorted(common))

    def covers(self, routes: Sequence[str], metric: str = "us") -> bool:
        """True when EVERY grid covers every requested route — a fresh
        shard shape may interpolate between any pair of neighbors."""
        return bool(self.grids) and all(m.covers(routes, metric)
                                        for m in self.grids)

    def _d_group(self, d: float) -> List[CostModel]:
        """Grids at the d nearest in log-distance, sorted ascending by n."""
        best = min({float(m.meta["shard_shape"][1]) for m in self.grids},
                   key=lambda gd: abs(math.log(max(gd, 1.0))
                                      - math.log(max(d, 1.0))))
        group = [m for m in self.grids
                 if float(m.meta["shard_shape"][1]) == best]
        return sorted(group, key=lambda m: float(m.meta["shard_shape"][0]))

    def predict(self, route: str, features: Dict[str, float],
                metric: str = "us") -> float:
        n = max(float(features.get("n", 1.0)), 1.0)
        group = self._d_group(float(features.get("d", 1.0)))
        lo = [m for m in group if float(m.meta["shard_shape"][0]) <= n]
        hi = [m for m in group if float(m.meta["shard_shape"][0]) >= n]
        if not lo or not hi:       # outside the span: endpoint extrapolates
            m = group[0] if not lo else group[-1]
            return m.predict(route, features, metric)
        m0, m1 = lo[-1], hi[0]
        n0 = float(m0.meta["shard_shape"][0])
        n1 = float(m1.meta["shard_shape"][0])
        p0 = m0.predict(route, {**features, "n": n0}, metric)
        if n0 == n1:
            return p0
        p1 = m1.predict(route, {**features, "n": n1}, metric)
        t = (math.log(n) - math.log(n0)) / (math.log(n1) - math.log(n0))
        return float(math.exp((1.0 - t) * math.log(max(p0, 1e-300))
                              + t * math.log(max(p1, 1e-300))))


def fit(observations: Sequence[Observation],
        meta: Optional[Dict] = None) -> CostModel:
    """Least-squares fit of log(cost) per route over a calibration run.

    Routes with fewer observations than coefficients are left out (the
    model simply does not cover them -> static-threshold fallback);
    non-positive measurements are dropped rather than poisoning the log
    fit. ``fit_stats`` reports median/max relative error of the us fit on
    its own calibration grid — the honesty metric CI bounds.
    """
    by_route: Dict[str, List[Observation]] = {}
    for ob in observations:
        by_route.setdefault(ob.route, []).append(ob)
    coef: Dict[str, Dict[str, List[float]]] = {}
    stats: Dict[str, Dict[str, float]] = {}
    for route, obs in by_route.items():
        X = np.stack([phi(route, ob.features) for ob in obs])
        fitted: Dict[str, List[float]] = {}
        for metric in METRICS:
            y = np.asarray([getattr(ob, metric) for ob in obs], np.float64)
            ok = y > 0
            # a term whose column is identically zero on this grid (e.g.
            # log(n_clauses) when every observation is an atomic filter)
            # is structurally absent: it costs no degree of freedom, and
            # min-norm lstsq pins its coefficient at exactly 0
            n_params = int(np.any(X[ok] != 0.0, axis=0).sum())
            if int(ok.sum()) < n_params:
                continue
            w, *_ = np.linalg.lstsq(X[ok], np.log(y[ok]), rcond=None)
            fitted[metric] = [float(v) for v in w]
            if metric == "us":
                pred = np.exp(X[ok] @ w)
                rel = np.abs(pred - y[ok]) / y[ok]
                stats[route] = {
                    "n_obs": int(ok.sum()),
                    "median_rel_err": float(np.median(rel)),
                    "max_rel_err": float(np.max(rel)),
                }
        if fitted:
            coef[route] = fitted
    return CostModel(coef=coef, meta=dict(meta or {}), fit_stats=stats)


class CostModelRouter:
    """Argmin-of-predicted-cost router over the executor's base routes.

    Built per search call (``serve.Executor.cost_router``) with the live
    serving shape; replaces ``planner.choose_route``'s threshold ladder.
    A streaming index's constant per-query delta tax (delta scan + merge)
    is folded into EVERY base route's prediction — it cancels in the
    argmin but makes ``costs()`` report the true per-query totals, the
    same totals the compaction break-even reasons about.
    """

    def __init__(self, model: CostModel, *, n: int, d: int, k: int,
                 ls: int, delta_n: int = 0, b: int = 1, metric: str = "us",
                 routes: Tuple[str, ...] = BASE_ROUTES, n_leaves: int = 1):
        if not model.covers(routes, metric):
            raise ValueError(f"model covers {model.routes()}, router needs "
                             f"{routes} ({metric}) — fall back to static "
                             f"thresholds")
        self.model = model
        self.routes = routes
        self.metric = metric       # "us" (wall) or "n_dist" (the DC metric)
        self.n, self.d, self.k, self.ls = int(n), int(d), int(k), int(ls)
        self.delta_n, self.b = int(delta_n), int(b)
        # compound-filter clause count -> the prefilter log(n_clauses)
        # term; 1 (atomic) contributes nothing, so legacy behavior holds
        self.n_leaves = max(int(n_leaves), 1)
        self.delta_tax = delta_scan_tax(model, n=n, d=d, k=k,
                                        delta_n=delta_n, metric=metric)

    def features(self, sel: float) -> Dict[str, float]:
        return dict(sel=float(sel), n=self.n, d=self.d, k=self.k,
                    ls=self.ls, delta_n=self.delta_n, b=self.b,
                    n_clauses=self.n_leaves)

    def costs(self, sel: float) -> Dict[str, float]:
        """Predicted cost/query per base route (delta tax folded in)."""
        f = self.features(sel)
        return {r: self.model.predict(r, f, self.metric) + self.delta_tax
                for r in self.routes}

    def route(self, sel: float) -> str:
        """The cheapest predicted route; ties break in ``routes`` order."""
        costs = self.costs(sel)
        best = self.routes[0]
        for r in self.routes[1:]:
            if costs[r] < costs[best]:
                best = r
        return best


def delta_scan_tax(model: CostModel, *, n: int, d: int, k: int,
                   delta_n: int, metric: str = "us") -> float:
    """Predicted cost/query a live delta segment adds to ANY base route.

    The streaming executor scans the delta and merges its top-k into the
    base result on every search, so the tax is delta + merge (merge only
    when calibrated — it is tiny and may be absent from a minimal model).
    Zero when the delta is empty or the model has no delta curve.
    """
    if delta_n <= 0 or not model.covers(("delta",), metric):
        return 0.0
    f = dict(delta_n=delta_n, n=n, d=d, k=k)
    tax = model.predict("delta", f, metric)
    if model.covers(("merge",), metric):
        tax += model.predict("merge", f, metric)
    return tax
