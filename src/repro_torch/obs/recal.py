"""Telemetry-driven cost-model re-calibration with hysteresis (a copy of
``repro.obs.recal``).

Closes the ROADMAP loop "feed served-query telemetry back into
``cost.fit``": a window of :class:`~repro_torch.obs.trace.TraceRecord` becomes
calibration :class:`~repro_torch.cost.model.Observation` rows (the trace
already carries every canonical feature — sel, n, d, k, ls, n_clauses —
plus the observed us / n_dist), ``cost.fit`` re-fits the routes the
window actually served, and the refit only replaces the attached model
when BOTH gates pass:

1. drift gate — :func:`~repro_torch.obs.drift.detect_drift` flags the window
   (skippable with ``require_drift=False`` for forced refits);
2. hysteresis gate — the candidate's median relative error on a
   deterministic held-out split of the window is STRICTLY below the
   stale model's.  An unbiased window therefore never swaps (the stale
   model is already the argmin), which is what prevents oscillation.

Routes the window never served keep the stale model's coefficients
(coef-level merge), so a single-band traffic burst cannot shrink the
model's coverage below what ``Executor.cost_router`` requires.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..cost.model import BASE_ROUTES, CostModel, Observation, fit
from .drift import DEFAULT_THRESHOLD, DriftReport, detect_drift
from .trace import TraceRecord


def observations_from_traces(
        traces: Sequence[TraceRecord]) -> List[Observation]:
    """Convert served-query traces into ``cost.fit`` observations.

    The observation's route is the planner BAND (prefilter/graph/
    postfilter) — the cost model's vocabulary — not the realized layout
    descriptor.  Traces with non-positive wall time are dropped here the
    same way ``fit`` drops non-positive measurements.
    """
    out: List[Observation] = []
    for t in traces:
        if t.observed_us is None or t.observed_us <= 0:
            continue
        out.append(Observation(
            route=t.band,
            features=dict(sel=float(t.sel), n=float(t.n), d=float(t.d),
                          k=float(t.k), ls=float(t.ls),
                          delta_n=float(t.delta_n),
                          n_clauses=float(max(t.n_clauses, 1))),
            us=float(t.observed_us),
            n_dist=float(max(t.n_dist, 0))))
    return out


def heldout_error(model, traces: Sequence[TraceRecord],
                  metric: str = "us") -> Optional[float]:
    """Median relative error of ``model`` on a trace set, or None.

    Predictions are made directly with ``model.predict`` (no delta-tax
    folding) so stale and candidate models are compared on identical
    terms.  Works for any model exposing ``predict``/``covers`` — the
    sharded :class:`~repro_torch.cost.model.InterpolatedCostModel` included.
    """
    errs: List[float] = []
    for t in traces:
        observed = t.n_dist if metric == "n_dist" else t.observed_us
        if observed is None or observed <= 0:
            continue
        if not model.covers((t.band,), metric):
            continue
        feats = dict(sel=float(t.sel), n=float(t.n), d=float(t.d),
                     k=float(t.k), ls=float(t.ls), delta_n=float(t.delta_n),
                     n_clauses=float(max(t.n_clauses, 1)))
        pred = float(model.predict(t.band, feats, metric))
        errs.append(abs(pred - float(observed)) / float(observed))
    if not errs:
        return None
    s = sorted(errs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def _merge(stale, refit: CostModel, metric: str) -> CostModel:
    """Candidate = refit routes layered over the stale model's coef.

    Only possible when the stale model is a plain coefficient model; an
    ``InterpolatedCostModel`` (sharded multi-grid) has no single ``coef``
    table, so the bare refit stands alone and must cover the base routes
    by itself to pass the coverage gate.
    """
    if not hasattr(stale, "coef"):
        return refit
    coef = {r: dict(ms) for r, ms in stale.coef.items()}
    for r, ms in refit.coef.items():
        coef.setdefault(r, {}).update(ms)
    stats = dict(getattr(stale, "fit_stats", {}) or {})
    stats.update(refit.fit_stats)
    meta = dict(refit.meta)
    meta["merged_over"] = sorted(set(stale.coef) - set(refit.coef))
    return CostModel(coef=coef, meta=meta, fit_stats=stats)


@dataclass(frozen=True)
class RecalReport:
    """Outcome of one re-calibration attempt."""

    swapped: bool                  # True -> `model` is the new candidate
    reason: str                    # human-readable gate outcome
    model: object                  # candidate when swapped, else the stale model
    drift: Optional[DriftReport]
    stale_err: Optional[float]     # held-out median rel err, stale model
    refit_err: Optional[float]     # held-out median rel err, candidate
    n_train: int
    n_holdout: int


def recalibrate(model, traces: Sequence[TraceRecord], *,
                metric: str = "us",
                min_traces: int = 64,
                drift_threshold: float = DEFAULT_THRESHOLD,
                require_drift: bool = True,
                holdout_every: int = 4,
                routes: Tuple[str, ...] = BASE_ROUTES) -> RecalReport:
    """Refit ``model`` from a trace window; swap only if strictly better.

    The holdout split is deterministic (every ``holdout_every``-th
    comparable trace) so repeated calls over the same window reach the
    same verdict — no sampling jitter in the hysteresis decision.
    """
    usable = [t for t in traces
              if (t.n_dist if metric == "n_dist" else t.observed_us) and
              (t.n_dist if metric == "n_dist" else t.observed_us) > 0]
    if len(usable) < min_traces:
        return RecalReport(False, f"window too small ({len(usable)} < "
                           f"{min_traces} traces)", model, None, None, None,
                           0, 0)

    drift = detect_drift(usable, threshold=drift_threshold,
                         min_traces=max(4, min_traces // 8))
    if require_drift and not drift.any_drifted:
        return RecalReport(False, "no drift: " + drift.summary(), model,
                           drift, None, None, 0, 0)

    holdout = usable[::holdout_every]
    train = [t for i, t in enumerate(usable) if i % holdout_every != 0]
    if not holdout or not train:
        return RecalReport(False, "degenerate holdout split", model, drift,
                           None, None, len(train), len(holdout))

    meta = dict(getattr(model, "meta", {}) or {})
    meta.update(source="telemetry", n_traces=len(train))
    refit = fit(observations_from_traces(train), meta)
    candidate = _merge(model, refit, metric)
    if not candidate.covers(routes, metric):
        return RecalReport(False, f"refit covers {candidate.routes()}, "
                           f"router needs {routes}", model, drift, None,
                           None, len(train), len(holdout))

    stale_err = heldout_error(model, holdout, metric)
    refit_err = heldout_error(candidate, holdout, metric)
    if stale_err is None or refit_err is None:
        return RecalReport(False, "no comparable held-out traces", model,
                           drift, stale_err, refit_err, len(train),
                           len(holdout))
    if refit_err >= stale_err:
        return RecalReport(False, f"hysteresis: refit {refit_err:.3f} >= "
                           f"stale {stale_err:.3f} on holdout", model, drift,
                           stale_err, refit_err, len(train), len(holdout))
    return RecalReport(True, f"refit {refit_err:.3f} < stale "
                       f"{stale_err:.3f} on {len(holdout)} held-out traces",
                       candidate, drift, stale_err, refit_err, len(train),
                       len(holdout))


__all__ = ["RecalReport", "recalibrate", "observations_from_traces",
           "heldout_error"]
