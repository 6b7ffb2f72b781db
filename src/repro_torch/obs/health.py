"""Serving health: one pass/warn/fail SLO document for the whole stack (a copy of
``repro.obs.health``).

``health_report`` fuses the quality and cost observability signals into
a single machine-checkable document:

* **shadow recall** — per route × band × epoch cells from
  ``obs.shadow`` audit records, judged against the recall SLO with the
  Wilson interval: *fail* only when the interval's upper bound is below
  the SLO (the estimator is confident recall is bad), *warn* when the
  point estimate is below it or the cell has too few trials to say.
* **dead ends** — per-route dead-end rate from introspection trace
  fields (``obs.introspect``), warn/fail thresholds.
* **latency** — per-route p50/p95/p99 over the trace window's
  ``observed_us`` (same percentile arithmetic as ``tools/jagstat.py``),
  judged against an optional p99 SLO.
* **drift** — ``obs.drift`` flags as warnings (a drifting cost model is
  a leading indicator, not a user-facing failure).

Overall status is the worst section status.  ``render_health`` formats
the document for ``tools/jagstat.py --health``; ``Telemetry.
health_report()`` builds one from live serving state.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence

import numpy as np

from .drift import DEFAULT_THRESHOLD, detect_drift
from .introspect import introspection_summary
from .shadow import RecallCell, cells_from_records

PASS, WARN, FAIL = "pass", "warn", "fail"
_ORDER = {PASS: 0, WARN: 1, FAIL: 2}


def _worst(statuses: Sequence[str]) -> str:
    return max(statuses, key=_ORDER.__getitem__) if statuses else PASS


@dataclass(frozen=True)
class HealthSLO:
    """The thresholds one serving deployment is judged against."""

    recall: float = 0.9            # recall@k floor per route × band cell
    min_shadow_trials: int = 20    # below this a cell can only warn, not pass
    p99_us: Optional[float] = None          # per-route p99 bound (None = off)
    dead_end_warn: float = 0.5     # dead ends per hop: warn above
    dead_end_fail: float = 0.9     # ... fail above
    drift_threshold: float = DEFAULT_THRESHOLD


def _shadow_section(shadow_records, slo: HealthSLO) -> dict:
    cells = cells_from_records(shadow_records)
    rows: List[dict] = []
    for (route, band, epoch) in sorted(cells):
        cell: RecallCell = cells[(route, band, epoch)]
        lo, hi = cell.wilson()
        if cell.trials == 0:
            status, why = WARN, "no trials (vacuous filters only)"
        elif hi < slo.recall:
            status = FAIL
            why = (f"recall confidently below SLO "
                   f"(CI upper {hi:.3f} < {slo.recall:g})")
        elif cell.estimate < slo.recall:
            status = WARN
            why = (f"point estimate {cell.estimate:.3f} below SLO "
                   f"{slo.recall:g} (CI straddles)")
        elif cell.trials < slo.min_shadow_trials:
            status = WARN
            why = (f"only {cell.trials} trials "
                   f"(< {slo.min_shadow_trials} for a confident pass)")
        else:
            status, why = PASS, ""
        rows.append({"route": route, "band": band, "epoch": epoch,
                     "n_queries": cell.n_queries, "trials": cell.trials,
                     "recall": round(cell.estimate, 4),
                     "wilson_lo": round(lo, 4), "wilson_hi": round(hi, 4),
                     "status": status, "why": why})
    status = _worst([r["status"] for r in rows]) if rows else WARN
    note = "" if rows else "no shadow audits recorded"
    return {"status": status, "note": note, "cells": rows}


def _dead_end_section(traces, slo: HealthSLO) -> dict:
    rows = []
    for r in introspection_summary(traces):
        rate = r["dead_end_rate"]
        if rate is None:
            status = WARN
        elif rate > slo.dead_end_fail:
            status = FAIL
        elif rate > slo.dead_end_warn:
            status = WARN
        else:
            status = PASS
        rows.append({**r, "status": status})
    status = _worst([r["status"] for r in rows]) if rows else PASS
    note = "" if rows else "no introspection counters in the window"
    return {"status": status, "note": note, "routes": rows}


def _latency_section(traces, slo: HealthSLO) -> dict:
    groups = {}
    for t in traces:
        groups.setdefault(t.route, []).append(float(t.observed_us))
    rows = []
    for route in sorted(groups):
        lat = np.asarray(groups[route], np.float64)
        p99 = float(np.percentile(lat, 99))
        if slo.p99_us is None:
            status = PASS
        elif p99 > 2.0 * slo.p99_us:
            status = FAIL
        elif p99 > slo.p99_us:
            status = WARN
        else:
            status = PASS
        rows.append({"route": route, "queries": int(lat.size),
                     "p50_us": round(float(np.percentile(lat, 50)), 1),
                     "p95_us": round(float(np.percentile(lat, 95)), 1),
                     "p99_us": round(p99, 1), "status": status})
    status = _worst([r["status"] for r in rows]) if rows else PASS
    note = "" if rows else "no traces in the window"
    return {"status": status, "note": note, "routes": rows}


def _drift_section(traces, slo: HealthSLO) -> dict:
    rep = detect_drift(traces, threshold=slo.drift_threshold)
    status = WARN if rep.any_drifted else PASS
    return {"status": status, "summary": rep.summary(),
            "median_rel_err": {b: round(e, 4)
                               for b, e in rep.median_rel_err.items()},
            "drifted": dict(rep.drifted)}


def health_report(traces, shadow_records=(),
                  slo: HealthSLO = HealthSLO()) -> dict:
    """Fuse recall, dead-end, latency, and drift signals into one SLO doc.

    ``traces`` is any iterable of ``TraceRecord`` (a live ``TraceBuffer``
    or a loaded dump); ``shadow_records`` any iterable of
    ``ShadowRecord``.  Pure host-side aggregation — safe to run on a
    serving process or offline on dumped windows.
    """
    traces = list(traces)
    shadow_records = list(shadow_records)
    sections = {
        "shadow_recall": _shadow_section(shadow_records, slo),
        "dead_ends": _dead_end_section(traces, slo),
        "latency": _latency_section(traces, slo),
        "drift": _drift_section(traces, slo),
    }
    return {"status": _worst([s["status"] for s in sections.values()]),
            "slo": asdict(slo),
            "n_traces": len(traces),
            "n_shadow": len(shadow_records),
            **sections}


def render_health(report: dict) -> str:
    """Human-readable rendering of a :func:`health_report` document."""
    mark = {PASS: "ok  ", WARN: "WARN", FAIL: "FAIL"}
    lines = [f"health: {report['status'].upper()}  "
             f"({report['n_traces']} traces, "
             f"{report['n_shadow']} shadow audits)"]
    sh = report["shadow_recall"]
    lines.append(f"[{mark[sh['status']]}] shadow recall"
                 + (f" — {sh['note']}" if sh["note"] else ""))
    for c in sh["cells"]:
        why = f"  ({c['why']})" if c["why"] else ""
        lines.append(
            f"         {c['route']:<24} {c['band']:<12} epoch={c['epoch']} "
            f"recall={c['recall']:.3f} "
            f"ci=[{c['wilson_lo']:.3f},{c['wilson_hi']:.3f}] "
            f"trials={c['trials']} [{c['status']}]{why}")
    de = report["dead_ends"]
    lines.append(f"[{mark[de['status']]}] dead ends"
                 + (f" — {de['note']}" if de["note"] else ""))
    for r in de["routes"]:
        rate = "-" if r["dead_end_rate"] is None else f"{r['dead_end_rate']:.3f}"
        lines.append(
            f"         {r['route']:<24} rate={rate} "
            f"hops~={r['mean_hops']} sat~={r['mean_sat_step']} "
            f"[{r['status']}]")
    la = report["latency"]
    lines.append(f"[{mark[la['status']]}] latency"
                 + (f" — {la['note']}" if la["note"] else ""))
    for r in la["routes"]:
        lines.append(
            f"         {r['route']:<24} p50={r['p50_us']} p95={r['p95_us']} "
            f"p99={r['p99_us']} us [{r['status']}]")
    dr = report["drift"]
    lines.append(f"[{mark[dr['status']]}] {dr['summary']}")
    return "\n".join(lines)


__all__ = ["FAIL", "HealthSLO", "PASS", "WARN", "health_report",
           "render_health"]
