"""Per-query trace records and the bounded host-side ring buffer (a copy of
``repro.obs.trace``).

A :class:`TraceRecord` is one served query: which planner band it fell
into, which route variant actually ran (the realized descriptor, e.g.
``graph[fused,int8]`` or ``prefilter+delta``), the sampled selectivity,
the per-route predicted costs the router compared, and the observed
outcome (wall-clock microseconds, ``n_dist``/``n_expanded`` pulled from
the already device-resident ``SearchResult``).

Records are appended by host-side wrappers after the group has finished
on the device (``torch.cuda.synchronize``), never from inside a route, so
tracing changes nothing about the routes.  The buffer is a
fixed-capacity ring: appends are O(1), old records fall off the front,
and ``dropped`` counts what fell off.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, fields
from typing import Dict, Iterator, List, Optional


@dataclass(frozen=True)
class TraceRecord:
    """One served query, as observed by the host-side telemetry wrapper."""

    qid: int                 # monotonically increasing per-Telemetry query id
    ts: float                # host unix timestamp at record time
    epoch: int               # index epoch the query was served at
    band: str                # planner band: prefilter | graph | postfilter
    route: str               # realized descriptor, e.g. "graph[fused,int8]"
    group: int               # banded group index within the dispatch
    group_size: int          # queries sharing this group's compiled call
    batch: int               # full search_auto batch size
    mode: str                # "per_query" | "batch"
    sel: float               # sampled selectivity for this query
    k: int
    ls: int
    n: int                   # database rows (per-shard n_loc when sharded)
    d: int
    n_clauses: int           # filter expression leaf count
    delta_n: int             # streaming delta rows at serve time (0 if frozen)
    shard: Optional[List[int]]        # [n_shards, n_loc] or None
    predicted: Optional[Dict[str, float]]  # per-route predicted cost at sel
    cost_metric: Optional[str]             # metric of `predicted` ("us"|"n_dist")
    observed_us: float       # wall-clock us for this query (group wall / size)
    n_dist: int              # distance computations (from SearchResult)
    n_expanded: int          # beam expansions (from SearchResult)
    # traversal introspection (Telemetry(introspect=True), graph routes
    # only) — None when the introspective variant didn't serve this query.
    # Optional-with-default so pre-introspection JSONL dumps still load.
    dead_ends: Optional[int] = None   # iterations with no filter-valid gain
    sat_step: Optional[int] = None    # last beam-improving iteration (1-based)


_FIELDS = tuple(f.name for f in fields(TraceRecord))


class TraceBuffer:
    """Bounded ring buffer of :class:`TraceRecord`.

    Iteration yields records oldest-first.  ``dropped`` counts records
    evicted since construction; ``clear()`` resets both.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[Optional[TraceRecord]] = [None] * self.capacity
        self._head = 0          # next write slot
        self._size = 0
        self.dropped = 0

    def __len__(self) -> int:
        return self._size

    def append(self, rec: TraceRecord) -> None:
        if self._size == self.capacity:
            self.dropped += 1
        else:
            self._size += 1
        self._buf[self._head] = rec
        self._head = (self._head + 1) % self.capacity

    def __iter__(self) -> Iterator[TraceRecord]:
        start = (self._head - self._size) % self.capacity
        for i in range(self._size):
            rec = self._buf[(start + i) % self.capacity]
            assert rec is not None
            yield rec

    def window(self, n: Optional[int] = None) -> List[TraceRecord]:
        """The most recent ``n`` records (all, when ``n`` is None)."""
        recs = list(self)
        return recs if n is None else recs[-n:]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._head = 0
        self._size = 0
        self.dropped = 0

    def dump_jsonl(self, path: str) -> int:
        """Write all buffered records as JSON-lines; returns the count.

        The first line is a meta header (``__trace_meta__``) carrying the
        ring's ``capacity`` and ``dropped`` counter so a round-trip
        through :func:`load_buffer` preserves them; :func:`load_jsonl`
        (and any line-oriented consumer filtering on record keys) skips
        it.
        """
        n = 0
        with open(path, "w") as fh:
            fh.write(json.dumps({"__trace_meta__": 1,
                                 "capacity": self.capacity,
                                 "dropped": self.dropped}) + "\n")
            for rec in self:
                fh.write(json.dumps(asdict(rec)) + "\n")
                n += 1
        return n


def load_jsonl(path: str) -> List[TraceRecord]:
    """Load a ``dump_jsonl`` trace file back into records.

    Unknown keys are ignored and missing keys (beyond the dataclass's
    optional tail) error — the schema is the dataclass, not the file.
    Meta header lines are skipped; files dumped before the header
    existed load unchanged.
    """
    out: List[TraceRecord] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            raw = json.loads(line)
            if "__trace_meta__" in raw:
                continue
            out.append(TraceRecord(**{k: v for k, v in raw.items() if k in _FIELDS}))
    return out


def load_buffer(path: str) -> TraceBuffer:
    """Restore a :class:`TraceBuffer` from a ``dump_jsonl`` file.

    Capacity and the ``dropped`` counter come from the meta header; a
    headerless (pre-header) dump restores with capacity = record count
    (minimum 1) and ``dropped = 0``.
    """
    capacity = None
    dropped = 0
    with open(path) as fh:
        first = fh.readline().strip()
    if first:
        raw = json.loads(first)
        if "__trace_meta__" in raw:
            capacity = int(raw.get("capacity", 0)) or None
            dropped = int(raw.get("dropped", 0))
    records = load_jsonl(path)
    buf = TraceBuffer(capacity or max(len(records), 1))
    for rec in records:
        buf.append(rec)
    buf.dropped = dropped
    return buf


__all__ = ["TraceRecord", "TraceBuffer", "load_buffer", "load_jsonl"]
