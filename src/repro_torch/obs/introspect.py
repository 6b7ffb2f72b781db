"""Host-side aggregation of traversal introspection counters (counterpart
of ``repro.obs.introspect``).

The device side lives in ``core.beam_search`` (``introspect=True``
returns a :class:`~repro_torch.core.beam_search.TraversalStats` of
per-query ``hops`` / ``sat_step`` / ``dead_ends`` tensors, computed on the
device from what the loop already holds) and runs behind its own
cache-key component of the executor's graph route (``Executor.graph(...,
introspect=True)``).  ``Telemetry(introspect=True)`` turns it on for
every served graph query and stamps the counters into trace records.

This module is the host half: pull stats across the device boundary,
summarize dead-end behavior per route (the FAVOR-style signal — the
paper's "prevents navigational dead-ends" claim, measured), and feed the
health report.

A *dead end* is an iteration where the lane was active but no
filter-valid candidate entered the kept beam; ``dead_end_rate`` is dead
ends per hop — 0.0 means every expansion made filter-valid progress,
1.0 means the traversal never did.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.beam_search import TraversalStats


def stats_to_host(stats: TraversalStats) -> Dict[str, np.ndarray]:
    """Device TraversalStats -> host int64 arrays (one copy per field)."""
    return {name: getattr(stats, name).cpu().numpy().astype(np.int64)
            for name in ("hops", "sat_step", "dead_ends")}


def dead_end_rate(dead_ends: int, hops: int) -> Optional[float]:
    """Dead ends per hop; None when there were no hops to judge."""
    return None if hops <= 0 else dead_ends / hops


def introspection_summary(traces: Sequence) -> List[dict]:
    """Per-route introspection rows from a trace window.

    Only traces carrying the introspection fields contribute (records
    from non-graph routes, or served before ``Telemetry(introspect=
    True)``, have ``dead_ends is None`` and are skipped).  ``hops`` is
    the existing ``n_expanded`` field; ``sat_frac`` is the mean fraction
    of the traversal spent past the last beam improvement — a high value
    means iterations were spent on a saturated frontier.
    """
    groups: Dict[str, List] = {}
    for t in traces:
        if getattr(t, "dead_ends", None) is None:
            continue
        groups.setdefault(t.route, []).append(t)
    rows = []
    for route in sorted(groups):
        rs = groups[route]
        hops = np.asarray([t.n_expanded for t in rs], np.float64)
        dead = np.asarray([t.dead_ends for t in rs], np.float64)
        sat = np.asarray([t.sat_step for t in rs], np.float64)
        total_hops = float(hops.sum())
        rows.append({
            "route": route,
            "queries": len(rs),
            "mean_hops": round(float(hops.mean()), 2),
            "mean_dead_ends": round(float(dead.mean()), 2),
            "dead_end_rate": (round(float(dead.sum()) / total_hops, 4)
                              if total_hops > 0 else None),
            "mean_sat_step": round(float(sat.mean()), 2),
            "sat_frac": (round(float(np.mean(
                np.where(hops > 0, 1.0 - sat / np.maximum(hops, 1.0), 0.0)
            )), 4) if len(rs) else None),
        })
    return rows


__all__ = ["TraversalStats", "dead_end_rate", "introspection_summary",
           "stats_to_host"]
