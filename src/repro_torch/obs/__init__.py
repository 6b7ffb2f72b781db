"""Serving telemetry (counterpart of ``repro.obs``): per-query traces,
route metrics, drift-driven recalibration, and quality observability
(shadow-oracle recall, traversal introspection, pipeline spans, the
serving health report).

Attach to any index with ``index.attach_telemetry()`` (off by default,
detach with ``attach_telemetry(None)``). Everything runs on the host after
each route group has finished on the device; the routes themselves are
unchanged. The introspective graph route (``Telemetry(introspect=True)``)
is its own executor cache entry whose extra outputs are device-side
counters, with ids and keys bit for bit those of the standard route. The
JSONL of traces and shadow records and the Chrome trace of spans are the
reference's formats.
"""
from .drift import DriftReport, detect_drift, relative_error
from .health import HealthSLO, health_report, render_health
from .introspect import introspection_summary, stats_to_host
from .metrics import Counter, Histogram, MetricsRegistry
from .recal import RecalReport, heldout_error, observations_from_traces, recalibrate
from .shadow import (ShadowAuditor, ShadowRecord, cells_from_records,
                     load_shadow_jsonl, sel_band, wilson_interval)
from .spans import Span, SpanRecorder
from .telemetry import Telemetry
from .trace import TraceBuffer, TraceRecord, load_buffer, load_jsonl

__all__ = [
    "Counter",
    "DriftReport",
    "HealthSLO",
    "Histogram",
    "MetricsRegistry",
    "RecalReport",
    "ShadowAuditor",
    "ShadowRecord",
    "Span",
    "SpanRecorder",
    "Telemetry",
    "TraceBuffer",
    "TraceRecord",
    "cells_from_records",
    "detect_drift",
    "health_report",
    "heldout_error",
    "introspection_summary",
    "load_buffer",
    "load_jsonl",
    "load_shadow_jsonl",
    "observations_from_traces",
    "recalibrate",
    "relative_error",
    "render_health",
    "sel_band",
    "stats_to_host",
    "wilson_interval",
]
