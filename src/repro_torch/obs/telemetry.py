"""The serving-telemetry facade attached via ``JAGIndex.attach_telemetry``
(counterpart of ``repro.obs.telemetry``).

One :class:`Telemetry` object owns the trace ring buffer, the metrics
registry, and the drift/re-calibration policy.  Everything here runs on
the host after the route has finished on the device (the dispatch layer
waits for each group before calling back), so attaching telemetry changes
nothing about the routes the executor runs; result tensors are read
through ``.cpu().numpy()``.

Hook surface (all host-side, all cheap):

- ``record_call``      one ``search_auto`` call -> one trace per query
- ``on_executor_miss`` executor route-cache miss (new ``(epoch,)+key``)
- ``on_epoch_roll``    executor dropped its caches for a new epoch
- ``on_compaction``    streaming delta folded into the frozen graph
- ``on_search``        streaming search observed (delta scanned or not)
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .drift import DEFAULT_THRESHOLD, DriftReport, detect_drift
from .metrics import MetricsRegistry
from .recal import RecalReport, recalibrate
from .shadow import ShadowAuditor, _host
from .spans import SpanRecorder
from .trace import TraceBuffer, TraceRecord


class Telemetry:
    """Bounded trace buffer + metrics registry + recalibration policy.

    ``recal_every > 0`` turns on auto-recalibration: every that-many
    traced ``search_auto`` calls, ``maybe_recalibrate`` runs against the
    index the traces came from (drift-gated, hysteresis-gated).

    Quality observability (all off by default):

    * ``shadow`` — a sampling fraction in (0, 1] (or a pre-built
      :class:`~repro_torch.obs.shadow.ShadowAuditor`): that fraction of served
      queries is deterministically sampled for exact-oracle replay.
      Serve time only pays a cheap host-side enqueue; the oracle runs at
      flush/report time, maintaining rolling recall estimators per
      realized route × selectivity band × epoch.
    * ``introspect`` — serve graph queries through the executor's
      introspective route (own cache-key component, bit-identical
      results) and stamp per-query hops / saturation step / dead-end
      counters into the trace records.
    * ``spans`` — record hierarchical pipeline spans
      (plan → gather → execute → scatter → merge) into a
      :class:`~repro_torch.obs.spans.SpanRecorder` with Chrome-trace
      export.
    """

    def __init__(self, *, capacity: int = 4096,
                 drift_threshold: float = DEFAULT_THRESHOLD,
                 recal_every: int = 0,
                 recal_min_traces: int = 64,
                 enabled: bool = True,
                 shadow=0.0,
                 introspect: bool = False,
                 spans=False):
        self.traces = TraceBuffer(capacity)
        self.metrics = MetricsRegistry()
        self.drift_threshold = float(drift_threshold)
        self.recal_every = int(recal_every)
        self.recal_min_traces = int(recal_min_traces)
        self.enabled = bool(enabled)
        self.last_recal: Optional[RecalReport] = None
        if isinstance(shadow, ShadowAuditor):
            self.shadow: Optional[ShadowAuditor] = shadow
        else:
            self.shadow = (ShadowAuditor(float(shadow), capacity=capacity)
                           if shadow else None)
        self.introspect = bool(introspect)
        if isinstance(spans, SpanRecorder):
            self.spans: Optional[SpanRecorder] = spans
        else:
            self.spans = SpanRecorder() if spans else None
        self._qid = 0
        self._calls = 0

    # ---- executor / streaming hooks ------------------------------------

    def on_executor_miss(self, epoch_key: Tuple) -> None:
        """New entry in the executor's route cache."""
        route = str(epoch_key[1]) if len(epoch_key) > 1 else "?"
        self.metrics.counter("jag_jit_miss_total", route=route).inc()

    def on_epoch_roll(self, epoch: int) -> None:
        """Executor dropped caches because the index epoch advanced."""
        self.metrics.counter("jag_epoch_roll_total").inc()

    def on_compaction(self) -> None:
        self.metrics.counter("jag_compaction_total").inc()

    def on_search(self, *, delta_scanned: bool) -> None:
        """One streaming search; tracks the delta-scan fraction."""
        self.metrics.counter("jag_stream_search_total").inc()
        if delta_scanned:
            self.metrics.counter("jag_delta_scan_total").inc()

    def delta_scan_fraction(self) -> float:
        total = self.metrics.value("jag_stream_search_total")
        if total == 0:
            return 0.0
        return self.metrics.value("jag_delta_scan_total") / total

    def jit_misses(self) -> int:
        return self.metrics.counter_total("jag_jit_miss_total")

    # ---- per-call trace recording --------------------------------------

    @staticmethod
    def _index_shape(index) -> Tuple[int, int, Optional[list]]:
        """(n, d, shard) — per-shard n_loc when the index is sharded."""
        n_loc = getattr(index, "n_loc", None)
        if n_loc is not None:     # sharded: xb is [S, n_loc, d]
            return int(n_loc), int(index.d), [int(index.n_shards), int(n_loc)]
        return int(index.xb.shape[0]), int(index.xb.shape[1]), None

    def record_call(self, index, plan, groups: Sequence[Tuple], *,
                    k: int, ls: int, router=None, filt=None,
                    mode: str = "per_query") -> None:
        """Record one ``search_auto`` call: one trace per served query.

        ``groups`` is ``[(band, realized, ids, result, stats,
        wall_seconds)]`` as timed by the dispatch layer — ``result`` has
        finished on the device, so pulling ``n_dist``/``n_expanded`` (and
        the introspective ``TraversalStats``, when present) to the host
        is a copy.  ``stats`` is None on non-graph routes and when
        introspection is off.
        """
        if not self.enabled:
            return
        now = time.time()
        n, d, shard = self._index_shape(index)
        epoch = int(getattr(index, "epoch", 0))
        delta = getattr(index, "delta", None)
        delta_n = int(delta.n) if hasattr(index, "delta_arrays") else 0
        n_clauses = int(getattr(router, "n_leaves", 1) or 1)
        metric = getattr(router, "metric", None) if router is not None else None
        # a streaming index with live delta rows merges the delta scan into
        # every search — the realized route the trace reports says so (the
        # same "+delta" suffix the returned plan carries)
        suffix = "+delta" if delta_n > 0 else ""
        sel = np.asarray(plan.selectivity, np.float64).reshape(-1)
        pred_cache: Dict[float, Dict[str, float]] = {}

        self.metrics.counter("jag_search_total").inc()
        for gi, (band, realized, ids, res, stats, wall_s) in enumerate(groups):
            ids = np.asarray(ids).reshape(-1)
            size = max(int(ids.size), 1)
            per_us = float(wall_s) * 1e6 / size
            n_dist = _host(res.n_dist).reshape(-1)
            n_exp = _host(res.n_expanded).reshape(-1)
            dead = sat = None
            if stats is not None:
                dead = _host(stats.dead_ends).reshape(-1)
                sat = _host(stats.sat_step).reshape(-1)
                self.metrics.counter("jag_introspect_query_total",
                                     route=band).inc(size)
                self.metrics.counter("jag_dead_end_total",
                                     route=band).inc(int(dead.sum()))
            self.metrics.counter("jag_route_call_total", route=band).inc()
            self.metrics.counter("jag_route_query_total", route=band).inc(size)
            lat = self.metrics.histogram("jag_latency_us", route=band,
                                         lo=1.0, factor=2.0, n_buckets=32)
            nds = self.metrics.histogram("jag_n_dist", route=band,
                                         lo=1.0, factor=2.0, n_buckets=32)
            for j, qi in enumerate(ids):
                s = float(sel[qi]) if qi < sel.size else float(sel[-1])
                predicted = None
                if router is not None:
                    key = round(s, 6)
                    predicted = pred_cache.get(key)
                    if predicted is None:
                        # pure route prediction: subtract the streaming
                        # delta tax the router folds into every route —
                        # the group wall time below excludes the delta
                        # scan, which runs (and is counted) separately
                        tax = float(getattr(router, "delta_tax", 0.0))
                        predicted = {r: float(c) - tax
                                     for r, c in router.costs(s).items()}
                        pred_cache[key] = predicted
                lat.observe(per_us)
                nds.observe(float(n_dist[j]) if j < n_dist.size else 0.0)
                self.traces.append(TraceRecord(
                    qid=self._qid, ts=now, epoch=epoch, band=str(band),
                    route=str(realized) + suffix, group=gi, group_size=size,
                    batch=int(sel.size), mode=mode, sel=s, k=int(k),
                    ls=int(ls), n=n, d=d, n_clauses=n_clauses,
                    delta_n=delta_n, shard=shard, predicted=predicted,
                    cost_metric=metric, observed_us=per_us,
                    n_dist=int(n_dist[j]) if j < n_dist.size else 0,
                    n_expanded=int(n_exp[j]) if j < n_exp.size else 0,
                    dead_ends=(int(dead[j]) if dead is not None
                               and j < dead.size else None),
                    sat_step=(int(sat[j]) if sat is not None
                              and j < sat.size else None)))
                self._qid += 1

        self._calls += 1
        if self.recal_every > 0 and self._calls % self.recal_every == 0:
            self.maybe_recalibrate(index)

    # ---- shadow-oracle recall auditing ---------------------------------

    def shadow_audit(self, index, queries, filt, result, plan, *,
                     k: int) -> int:
        """Audit the sampled fraction of one served call's queries.

        Called by ``search_auto`` with the FINAL served result (after
        any streaming delta merge), after ``record_call`` — so the qids
        audited here are exactly the qids just traced.  Runs on the
        host, off the serving critical path; returns the number of
        queries audited (0 when shadow auditing is off or none sampled).
        """
        if not self.enabled or self.shadow is None:
            return 0
        sel = np.asarray(plan.selectivity, np.float64).reshape(-1)
        B = int(sel.size)
        realized = getattr(plan, "realized", None)
        if realized is None:
            realized = getattr(plan, "routes", None) or getattr(
                plan, "route", "?")
        routes = ([str(realized)] * B if isinstance(realized, str)
                  else [str(r) for r in realized])
        n = self.shadow.audit(
            index, queries, filt, result, k=int(k),
            qid0=max(self._qid - B, 0), routes=routes, sels=sel,
            epoch=int(getattr(index, "epoch", 0)))
        if n:
            self.metrics.counter("jag_shadow_audit_total").inc(n)
        return n

    # ---- health ---------------------------------------------------------

    def health_report(self, slo=None) -> dict:
        """The fused pass/warn/fail SLO document over live serving state.

        See ``repro_torch.obs.health.health_report``; the drift threshold
        defaults to this telemetry's.
        """
        from .health import HealthSLO, health_report
        if slo is None:
            slo = HealthSLO(drift_threshold=self.drift_threshold)
        if self.shadow is not None:
            self.shadow.flush()
        shadow = list(self.shadow.records) if self.shadow is not None else ()
        return health_report(self.traces.window(), shadow, slo)

    # ---- drift / re-calibration ----------------------------------------

    def drift_status(self, *, window: int = 512,
                     min_traces: int = 16) -> DriftReport:
        return detect_drift(self.traces, threshold=self.drift_threshold,
                            min_traces=min_traces, window=window)

    def maybe_recalibrate(self, index, *, require_drift: bool = True,
                          window: Optional[int] = None) -> RecalReport:
        """Drift-gated, hysteresis-gated refit of the index's cost model.

        On a swap the candidate is attached back onto the index via
        ``attach_cost_model`` (same metric), so the very next
        ``search_auto`` routes with the re-calibrated model.
        """
        model = getattr(index, "cost_model", None)
        metric = getattr(index, "cost_metric", "us")
        if model is None:
            report = RecalReport(False, "no cost model attached", None,
                                 None, None, None, 0, 0)
        else:
            report = recalibrate(model, self.traces.window(window),
                                 metric=metric,
                                 min_traces=self.recal_min_traces,
                                 drift_threshold=self.drift_threshold,
                                 require_drift=require_drift)
            if report.swapped:
                index.attach_cost_model(report.model, metric=metric)
                self.metrics.counter("jag_recal_swap_total").inc()
        self.last_recal = report
        return report


__all__ = ["Telemetry"]
