"""Cost-model drift detection over a trace window (a copy of
``repro.obs.drift``).

A trace is "driftable" when it carries the router's per-route predicted
costs alongside the observed outcome.  The per-trace signal is the
relative error of the prediction for the band that actually ran:

    rel_err = |predicted[band] - observed| / observed

with ``observed`` taken in the prediction's own metric (wall-clock us
or n_dist).  Per band we report the rolling-window median — medians
resist the long latency tail — and flag drift when it crosses the
threshold.  The default threshold (0.5) is deliberately far above the
calibration fit error CI bounds (~0.25 median on-grid), so an accurate
model never flaps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from .trace import TraceRecord

DEFAULT_THRESHOLD = 0.5


def relative_error(rec: TraceRecord) -> Optional[float]:
    """Predicted-vs-observed relative error for one trace, or None.

    None when the trace carries no prediction for its band, or the
    observation is non-positive (nothing meaningful to compare).
    """
    if not rec.predicted or rec.band not in rec.predicted:
        return None
    observed = rec.n_dist if rec.cost_metric == "n_dist" else rec.observed_us
    if observed is None or observed <= 0:
        return None
    return abs(float(rec.predicted[rec.band]) - float(observed)) / float(observed)


@dataclass(frozen=True)
class DriftReport:
    """Per-band median relative error and drift flags for one window."""

    median_rel_err: Dict[str, float]   # band -> rolling median rel err
    drifted: Dict[str, bool]           # band -> median > threshold
    n_traces: Dict[str, int]           # band -> traces contributing
    threshold: float
    window: int                        # traces considered (most recent)

    @property
    def any_drifted(self) -> bool:
        return any(self.drifted.values())

    def summary(self) -> str:
        if not self.median_rel_err:
            return "drift: no comparable traces"
        parts = []
        for band in sorted(self.median_rel_err):
            flag = "DRIFT" if self.drifted[band] else "ok"
            parts.append(f"{band}:{self.median_rel_err[band]:.3f}({flag})")
        return "drift: " + " ".join(parts)


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def detect_drift(traces: Iterable[TraceRecord], *,
                 threshold: float = DEFAULT_THRESHOLD,
                 min_traces: int = 16,
                 window: int = 512) -> DriftReport:
    """Median relative error per band over the most recent ``window`` traces.

    Bands with fewer than ``min_traces`` comparable traces are reported
    but never flagged — a handful of outliers must not trigger a refit.
    """
    recent = list(traces)[-window:]
    errs: Dict[str, List[float]] = {}
    for rec in recent:
        e = relative_error(rec)
        if e is not None:
            errs.setdefault(rec.band, []).append(e)
    med = {band: _median(es) for band, es in errs.items()}
    return DriftReport(
        median_rel_err=med,
        drifted={band: (len(errs[band]) >= min_traces and m > threshold)
                 for band, m in med.items()},
        n_traces={band: len(es) for band, es in errs.items()},
        threshold=threshold,
        window=len(recent))


__all__ = ["DriftReport", "detect_drift", "relative_error", "DEFAULT_THRESHOLD"]
