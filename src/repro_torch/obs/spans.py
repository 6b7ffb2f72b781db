"""Hierarchical span timing for the serving pipeline (a copy of
``repro.obs.spans``).

A :class:`SpanRecorder` wraps the host-side stages of one search —
plan → per-route gather → execute → scatter → merge — in nested
``with recorder.span(name):`` blocks and keeps a bounded list of
completed :class:`Span` records.  Timing is ``time.perf_counter`` on
the host around the route calls, never inside them: attaching spans
changes nothing about the routes the executor runs.

``chrome_trace()`` renders the recorded spans as Chrome trace-event
JSON (``"ph": "X"`` complete events, microsecond ``ts``/``dur``) —
``export_chrome_trace(path)`` writes a file that loads directly in
Perfetto / ``chrome://tracing``.  Nesting is expressed the way those
viewers expect: same pid/tid, containment by time range; ``depth`` is
additionally recorded in ``args`` for programmatic consumers.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class Span:
    """One completed pipeline stage."""

    name: str
    t0: float                  # seconds since the recorder's origin
    t1: float
    depth: int                 # nesting depth at entry (0 = top level)
    parent: Optional[str]      # enclosing span's name, if any
    args: Dict[str, object] = field(default_factory=dict)

    @property
    def duration_us(self) -> float:
        return (self.t1 - self.t0) * 1e6


class SpanRecorder:
    """Bounded recorder of nested host-side spans.

    Appends are O(1); once ``capacity`` spans are held the oldest are
    evicted (``dropped`` counts them).  Reentrant nesting is tracked
    with an explicit stack, so recording is single-threaded like the
    rest of the serving loop.
    """

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.spans: List[Span] = []
        self.dropped = 0
        self._stack: List[str] = []
        self._origin = time.perf_counter()

    @contextmanager
    def span(self, name: str, **args):
        """Time a pipeline stage; nest freely."""
        depth = len(self._stack)
        parent = self._stack[-1] if self._stack else None
        self._stack.append(name)
        t0 = time.perf_counter() - self._origin
        try:
            yield self
        finally:
            t1 = time.perf_counter() - self._origin
            self._stack.pop()
            self.spans.append(Span(name, t0, t1, depth, parent, dict(args)))
            if len(self.spans) > self.capacity:
                drop = len(self.spans) - self.capacity
                del self.spans[:drop]
                self.dropped += drop

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0

    def totals_us(self) -> Dict[str, float]:
        """Summed wall time per span name, microseconds."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_us
        return out

    def chrome_trace(self) -> List[dict]:
        """The recorded spans as Chrome trace-event complete events."""
        events = []
        for s in self.spans:
            args = dict(s.args)
            args["depth"] = s.depth
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({
                "name": s.name, "cat": "serve", "ph": "X",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round(s.duration_us, 3),
                "pid": 0, "tid": 0, "args": args,
            })
        return events

    def export_chrome_trace(self, path: str) -> int:
        """Write ``{"traceEvents": [...]}`` JSON; returns the event count.

        The object form (rather than the bare array) keeps the file
        self-describing; both load in Perfetto and chrome://tracing.
        """
        events = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, fh)
        return len(events)


__all__ = ["Span", "SpanRecorder"]
