"""Arithmetic the metric readers (``metrics/<name>.py``) share. A reader
gets the run's record and returns its metric's value, or None where the
run holds nothing to read."""
from __future__ import annotations

import math
from typing import Optional

from jagbench import work


def nearest_rank(values, pct: float) -> float:
    """The ``pct`` percentile of all ``values`` by nearest rank: the
    smallest value with at least ``pct`` percent of the values at or below
    it."""
    s = sorted(values)
    return s[max(math.ceil(pct / 100.0 * len(s)), 1) - 1]


def qps(run) -> float:
    """Queries of every batch completed in the window over the window's
    wall time (first send to the last batch's answers on the host)."""
    return sum(run.batch_queries) / run.window_s


def batch_p90_ms(run) -> float:
    """The 90th percentile, by nearest rank, of every batch's latency in
    the window (send to answers on the host)."""
    return 1e3 * nearest_rank(run.batch_s, 90)


def plan_dispatch_ms(run) -> Optional[float]:
    """Per batch of the traced window, its latency minus its groups'
    ``on_group`` times (planning, gather and scatter, the copies to the
    host), averaged over the batches."""
    if not run.groups:
        return None
    rest = [b - sum(s for _, _, s in g)
            for b, g in zip(run.batch_s, run.groups)]
    return 1e3 * sum(rest) / len(rest)


def device_idle_pct(run) -> Optional[float]:
    """100 minus the union of device events over the host's wall clock,
    across the profiled batches."""
    if run.prof is None:
        return None
    busy = run.prof["stats"]["device_busy_us"] / 1e6
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.prof["wall_s"])


def route_ms_per_kq(run, route: str) -> Optional[float]:
    """Milliseconds of device-finished group time per 1000 queries the
    planner sent to ``route``, over the traced run's window (each group
    timed by ``search_auto``'s ``on_group``)."""
    if not run.groups:
        return None
    secs = sum(s for g in run.groups for r, n, s in g if r == route)
    queries = sum(n for g in run.groups for r, n, s in g if r == route)
    if queries == 0:
        return None
    return secs * 1e3 / (queries / 1e3)


def kernel_roofline(run, kernel: str) -> Optional[float]:
    """The bound of the scan work the profiled batches' scanned queries
    need of ``kernel`` (``work.scan_bound_s``), as a percentage of the
    device time of the kernels named ``kernel`` in their trace."""
    if run.prof is None:
        return None
    dev_s = sum(row["device_ms"] / 1e3
                for name, row in run.prof["stats"]["kernels"].items()
                if kernel in name)
    if dev_s <= 0:
        return None
    bound = sum(work.scan_bound_s(kernel, q, run.n, run.d, run.words)
                for q in run.prof["scanned"] if q)
    return 100.0 * bound / dev_s
