"""Counter / histogram registry with a Prometheus-style text exposition (a copy of
``repro.obs.metrics``).

Pure host-side Python — no torch, no numpy arrays held.  Counters and
histograms are keyed by ``(name, sorted(labels))``; histograms use
geometric (log) buckets so one layout covers sub-microsecond latencies
and million-row ``n_dist`` counts alike.  Quantile accessors return the
upper bound of the bucket containing the target rank — the usual
Prometheus-histogram resolution contract.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double quote, and line feed must be backslash-escaped."""
    return (str(v).replace("\\", "\\\\")
                  .replace('"', '\\"')
                  .replace("\n", "\\n"))


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Geometric-bucket histogram: bounds ``lo * factor**i``.

    The last bucket is the +Inf overflow.  ``quantile(q)`` returns the
    upper bound of the bucket where the cumulative count first reaches
    ``q * count`` (``inf`` when that rank lands in the overflow bucket,
    0.0 when empty).
    """

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, lo: float = 1.0, factor: float = 2.0, n_buckets: int = 40):
        if lo <= 0 or factor <= 1 or n_buckets < 1:
            raise ValueError("need lo > 0, factor > 1, n_buckets >= 1")
        self.bounds = [lo * factor ** i for i in range(n_buckets)]
        self.counts = [0] * (n_buckets + 1)   # +1 = overflow (+Inf)
        self.count = 0
        self.sum = 0.0

    def _bucket(self, v: float) -> int:
        if v <= self.bounds[0]:
            return 0
        if v > self.bounds[-1]:
            return len(self.bounds)
        lo, factor = self.bounds[0], self.bounds[1] / self.bounds[0]
        i = int(math.ceil(math.log(v / lo) / math.log(factor) - 1e-9))
        # float-precision guard: the closed-form index can land one off
        while i > 0 and v <= self.bounds[i - 1]:
            i -= 1
        while v > self.bounds[i]:
            i += 1
        return i

    def observe(self, v: float) -> None:
        self.counts[self._bucket(float(v))] += 1
        self.count += 1
        self.sum += float(v)

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                return self.bounds[i] if i < len(self.bounds) else math.inf
        return math.inf

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named, labelled counters and histograms with text exposition."""

    def __init__(self):
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Counter] = {}
        self._histograms: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def histogram(self, name: str, *, lo: float = 1.0, factor: float = 2.0,
                  n_buckets: int = 40, **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(lo, factor, n_buckets)
        return h

    def value(self, name: str, **labels: str) -> int:
        """Current value of a counter (0 if it was never incremented)."""
        c = self._counters.get((name, _label_key(labels)))
        return 0 if c is None else c.value

    def counter_total(self, name: str) -> int:
        """Sum of a counter across all label sets."""
        return sum(c.value for (n, _), c in self._counters.items() if n == name)

    @staticmethod
    def _fmt_labels(labels: Tuple[Tuple[str, str], ...],
                    extra: Optional[Tuple[str, str]] = None) -> str:
        pairs = list(labels) + ([extra] if extra else [])
        if not pairs:
            return ""
        return ("{" + ",".join(f'{k}="{_escape_label(v)}"'
                               for k, v in pairs) + "}")

    def render(self) -> str:
        """Prometheus-style text exposition of every metric."""
        lines: List[str] = []
        for (name, labels), c in sorted(self._counters.items()):
            lines.append(f"{name}{self._fmt_labels(labels)} {c.value}")
        for (name, labels), h in sorted(self._histograms.items()):
            cum = 0
            for i, cnt in enumerate(h.counts):
                cum += cnt
                le = f"{h.bounds[i]:g}" if i < len(h.bounds) else "+Inf"
                lines.append(
                    f"{name}_bucket{self._fmt_labels(labels, ('le', le))} {cum}")
            lines.append(f"{name}_sum{self._fmt_labels(labels)} {h.sum:g}")
            lines.append(f"{name}_count{self._fmt_labels(labels)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly dump: counters plus histogram percentile summaries."""
        counters = {}
        for (name, labels), c in sorted(self._counters.items()):
            counters[name + self._fmt_labels(labels)] = c.value
        hists = {}
        for (name, labels), h in sorted(self._histograms.items()):
            hists[name + self._fmt_labels(labels)] = {
                "count": h.count, "sum": h.sum, **h.percentiles()}
        return {"counters": counters, "histograms": hists}


__all__ = ["Counter", "Histogram", "MetricsRegistry"]
