"""Shadow-oracle recall auditing: sampled online ground-truth checks
(counterpart of ``repro.obs.shadow``).

JAG's headline claim is *recall robustness*, but serving telemetry
observes only cost.  This module closes the loop without offline ground
truth: for a deterministic, configurable fraction of served queries the
auditor re-runs ``core.ground_truth.exact_filtered_knn`` over the same
filter expression — against the FULL live database (base rows plus any
streaming delta rows) — and folds the per-query hit counts into rolling
recall@k estimators keyed by realized route × selectivity band × epoch,
each with a Wilson score confidence interval.

Design constraints, all honored here:

* **Deterministic sampling** — membership is a pure hash of the
  telemetry-global query id (Knuth multiplicative hash), so a replayed
  workload audits the same queries and two processes agree without
  coordination.  Sequential qids map to an equidistributed hash
  sequence, so a fraction ``f`` samples ``~f`` of traffic evenly.
* **Off the critical path** — the serving side of an audit is a cheap
  enqueue: the sampled queries, the served top-k rows, and snapshot
  references to the live database arrays are captured after the served
  call returned, and the oracle replay runs later, at
  :meth:`ShadowAuditor.flush` (every reporting accessor flushes first;
  a bounded pending queue flushes synchronously at ``max_pending`` so
  memory cannot grow without bound).  Nothing here runs inside a route.
  The oracle is ``exact_filtered_knn`` on the index's device, through
  the scan kernels on the card (``gather_dist_tile``, and
  ``bitset_dist`` for Subset and Boolean filters); sampled sub-batches are
  padded to power-of-two buckets, as in the reference.
* **Exact arithmetic** — recall@k is counted the way
  ``core.recall.recall_at_k`` defines it: every ground-truth neighbor
  is one Bernoulli trial, a served id with the filter-valid key
  (``primary == 0``) that appears in the ground-truth set is a hit, and
  a vacuous query (no row passes the filter) contributes no trials.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .trace import TraceBuffer

# Knuth's multiplicative hash constant (2^32 / golden ratio)
_KNUTH = 2654435761
_Z95 = 1.959963984540054          # two-sided 95% normal quantile

# fixed geometric selectivity-band edges: the regimes the planner routes
# between (prefilter <=~1%, graph in the middle, postfilter >=~75%)
SEL_BAND_EDGES: Tuple[float, ...] = (0.001, 0.01, 0.1, 0.5)


def _host(t) -> np.ndarray:
    """A result tensor (or array) as a host numpy array."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def sel_band(sel: float) -> str:
    """The fixed selectivity band a sampled selectivity falls in."""
    for edge in SEL_BAND_EDGES:
        if sel <= edge:
            return f"sel<={edge:g}"
    return f"sel>{SEL_BAND_EDGES[-1]:g}"


def sampled_qid(qid: int, fraction: float) -> bool:
    """Deterministic hash-of-qid sampling at ``fraction`` of traffic."""
    if fraction >= 1.0:
        return True
    if fraction <= 0.0:
        return False
    return ((qid * _KNUTH) & 0xFFFFFFFF) < int(fraction * 4294967296.0)


def wilson_interval(successes: int, trials: int,
                    z: float = _Z95) -> Tuple[float, float]:
    """Wilson score interval for a binomial proportion.

    Well-behaved at small n and at p near 0/1 (unlike the normal
    approximation), which is exactly the sampled-shadow regime.
    """
    if trials <= 0:
        return (0.0, 1.0)
    n = float(trials)
    p = successes / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2.0 * n)) / denom
    half = z * math.sqrt(p * (1.0 - p) / n + z * z / (4.0 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


@dataclass(frozen=True)
class ShadowRecord:
    """One audited query: served result vs the exact oracle."""

    qid: int
    ts: float
    epoch: int
    route: str       # realized route descriptor (e.g. "graph[fused,int8]")
    band: str        # selectivity band (see :func:`sel_band`)
    sel: float
    k: int
    hits: int        # ground-truth neighbors present in the served top-k
    trials: int      # ground-truth neighbors (<= k; 0 = vacuous filter)
    recall: float    # hits / trials (1.0 on vacuous, recall_at_k convention)


class RecallCell:
    """Rolling recall estimator for one route × band × epoch cell."""

    __slots__ = ("hits", "trials", "n_queries")

    def __init__(self):
        self.hits = 0
        self.trials = 0
        self.n_queries = 0

    def update(self, hits: int, trials: int) -> None:
        self.hits += int(hits)
        self.trials += int(trials)
        self.n_queries += 1

    @property
    def estimate(self) -> float:
        return self.hits / self.trials if self.trials else 1.0

    def wilson(self, z: float = _Z95) -> Tuple[float, float]:
        return wilson_interval(self.hits, self.trials, z)


def _live_parts(index):
    """(vector segments, attr table) of every live row the index serves:
    the base vectors, then a streaming index's delta vectors; a sharded
    index's shards in shard order (shard-major, as its globalized ids
    ``local + shard * n_loc`` count them). Each segment stays fixed once
    captured (a delta append makes a new device copy), so the references
    are a snapshot without copying the database."""
    parts = (tuple(index.xb) if getattr(index, "n_loc", None) is not None
             else (index.xb,))
    if hasattr(index, "delta_arrays") and getattr(index.delta, "n", 0) > 0:
        xv, _, _ = index.delta_arrays()
        parts = parts + (xv,)
    return parts, index.attr


def oracle_arrays(index):
    """(vectors, attr table) covering every live row the index serves.

    Frozen ``JAGIndex``: the base arrays.  ``StreamingJAGIndex``: base
    vectors + delta vectors (``index.attr`` is already the merged live
    table, and delta ids are offset past the base — matching the oracle's
    row order exactly). ``ShardedJAGIndex``: the replicated union attr
    table with the shards' rows concatenated shard-major on the lead
    device, matching the globalized ids the sharded routes return.
    """
    parts, attr = _live_parts(index)
    return _concat(parts), attr


def _concat(parts) -> torch.Tensor:
    """The segments as one table on the first one's device."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(parts[0].device) for p in parts])


@dataclass(frozen=True)
class _PendingAudit:
    """One served call's sampled queries, snapshotted for deferred replay.

    ``parts``/``attr`` are references to the live tensors at serve time
    (the base vectors and a streaming index's delta vectors, concatenated
    one audit at a time at :meth:`ShadowAuditor.flush`; a later append
    makes a new delta tensor, so rows that exist later cannot leak into
    the snapshot); ``queries`` holds the sampled (bucket-padded) query
    rows on the index's device; served ids and the filter-valid mask are
    host copies of the sampled result rows.
    """

    parts: Tuple[torch.Tensor, ...]
    attr: object
    queries: torch.Tensor      # [bucket, d] on the index's device
    filt: object               # the (immutable) served filter
    padded: np.ndarray         # int32 [bucket] indices into the batch
    n_sampled: int
    served_ids: np.ndarray     # [n_sampled, k]
    served_ok: np.ndarray      # [n_sampled, k] bool
    routes: Tuple[str, ...]
    sels: Tuple[float, ...]
    qids: Tuple[int, ...]
    epoch: int
    k: int


class ShadowAuditor:
    """Sampled shadow-oracle recall estimation over served queries.

    ``fraction`` of queries (hash-of-qid) are re-answered exactly and
    compared to what was served; per-cell estimators aggregate across
    calls.  The serve-time half (:meth:`audit`) only enqueues host
    snapshots — the oracle replay runs at :meth:`flush`, which every
    reporting accessor calls first, so sampling stays off the serving
    critical path.  ``records`` is a bounded ring of per-query
    :class:`ShadowRecord` with JSONL dump/load, so ``jagstat --health``
    can rebuild the estimators offline.
    """

    def __init__(self, fraction: float = 0.05, capacity: int = 4096,
                 max_pending: int = 256):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        self.fraction = float(fraction)
        self.records = TraceBuffer(capacity)
        self.cells: Dict[Tuple[str, str, int], RecallCell] = {}
        self.n_audited = 0
        self.max_pending = int(max_pending)
        self._pending: List[_PendingAudit] = []

    @property
    def n_pending(self) -> int:
        """Sampled queries enqueued but not yet replayed."""
        return sum(e.n_sampled for e in self._pending)

    # -- the audit ---------------------------------------------------------
    def audit(self, index, queries, filt, result, *, k: int, qid0: int,
              routes: Sequence[str], sels, epoch: int = 0) -> int:
        """Enqueue the sampled subset of one served call; returns #sampled.

        ``result`` is the FINAL served ``SearchResult`` (post delta-merge
        for a streaming index), ``routes[i]``/``sels[i]`` the per-query
        realized route and sampled selectivity, ``qid0`` the telemetry
        qid of query 0.  Runs on the host after the served call returned
        and does no oracle work — it snapshots the sampled queries, the
        served rows, and the live database arrays, then defers the exact
        replay to :meth:`flush` (triggered automatically once
        ``max_pending`` calls accumulate, and by every reporting
        accessor).
        """
        sels = np.asarray(sels, np.float64).reshape(-1)
        B = int(sels.size)
        pos = [i for i in range(B) if sampled_qid(qid0 + i, self.fraction)]
        if not pos:
            return 0
        # pad the sampled sub-batch to a power-of-two bucket, as the
        # reference does (its oracle compiles per batch shape)
        bucket = 1 << (len(pos) - 1).bit_length()
        padded = np.asarray(pos + [pos[0]] * (bucket - len(pos)), np.int32)
        served_ids = _host(result.ids)[pos]
        served_ok = ((_host(result.primary)[pos] == 0.0)
                     & (served_ids >= 0))
        parts, attr = _live_parts(index)
        dev = parts[0].device
        q = torch.as_tensor(queries, device=dev)
        self._pending.append(_PendingAudit(
            parts=parts, attr=attr,
            queries=q[torch.as_tensor(padded, dtype=torch.int64,
                                      device=dev)],
            filt=filt, padded=padded,
            n_sampled=len(pos), served_ids=served_ids, served_ok=served_ok,
            routes=tuple(str(routes[i]) if i < len(routes)
                         else str(routes[-1]) for i in pos),
            sels=tuple(float(sels[i]) for i in pos),
            qids=tuple(int(qid0 + i) for i in pos),
            epoch=int(epoch), k=int(k)))
        if len(self._pending) >= self.max_pending:
            self.flush()
        return len(pos)

    def flush(self) -> int:
        """Replay every pending oracle audit; returns #queries audited."""
        if not self._pending:
            return 0
        from ..core.ground_truth import exact_filtered_knn

        pending, self._pending = self._pending, []
        n = 0
        for e in pending:
            f = e.filt.take(e.padded)
            # one concatenated copy of a streaming or sharded database at a
            # time
            xb = _concat(e.parts)
            gt = exact_filtered_knn(xb, e.attr, e.queries, f, k=e.k,
                                    use_kernel=xb.is_cuda)
            if xb.is_cuda:
                torch.cuda.synchronize(xb.device)
            gt_ids = gt.ids.cpu().numpy()
            del xb, gt
            now = time.time()
            for j in range(e.n_sampled):
                g = gt_ids[j]
                g = g[g >= 0]
                trials = int(g.size)
                s = e.served_ids[j][e.served_ok[j]]
                hits = int(np.intersect1d(s, g).size) if trials else 0
                band = sel_band(e.sels[j])
                cell = self.cells.setdefault(
                    (e.routes[j], band, e.epoch), RecallCell())
                cell.update(hits, trials)
                self.records.append(ShadowRecord(
                    qid=e.qids[j], ts=now, epoch=e.epoch,
                    route=e.routes[j], band=band, sel=e.sels[j], k=e.k,
                    hits=hits, trials=trials,
                    recall=(hits / trials) if trials else 1.0))
                self.n_audited += 1
                n += 1
        return n

    # -- reporting ---------------------------------------------------------
    def recall_table(self, z: float = _Z95) -> List[dict]:
        """Per-cell rows: estimate + Wilson bounds, route/band/epoch sorted."""
        self.flush()
        rows = []
        for (route, band, epoch) in sorted(self.cells):
            cell = self.cells[(route, band, epoch)]
            lo, hi = cell.wilson(z)
            rows.append({"route": route, "band": band, "epoch": epoch,
                         "n_queries": cell.n_queries,
                         "trials": cell.trials, "hits": cell.hits,
                         "recall": round(cell.estimate, 4),
                         "wilson_lo": round(lo, 4),
                         "wilson_hi": round(hi, 4)})
        return rows

    def dump_jsonl(self, path: str) -> int:
        """Write the audit records as JSON-lines; returns the count."""
        self.flush()
        return self.records.dump_jsonl(path)


def cells_from_records(records: Sequence[ShadowRecord]
                       ) -> Dict[Tuple[str, str, int], RecallCell]:
    """Rebuild per-cell estimators from dumped records (jagstat --health)."""
    cells: Dict[Tuple[str, str, int], RecallCell] = {}
    for r in records:
        cells.setdefault((r.route, r.band, int(r.epoch)),
                         RecallCell()).update(r.hits, r.trials)
    return cells


def load_shadow_jsonl(path: str) -> List[ShadowRecord]:
    """Load a :meth:`ShadowAuditor.dump_jsonl` file back into records."""
    import json
    from dataclasses import fields
    names = tuple(f.name for f in fields(ShadowRecord))
    out: List[ShadowRecord] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            raw = json.loads(line)
            if "__trace_meta__" in raw:
                continue
            out.append(ShadowRecord(**{k: v for k, v in raw.items()
                                       if k in names}))
    return out


__all__ = ["RecallCell", "SEL_BAND_EDGES", "ShadowAuditor", "ShadowRecord",
           "cells_from_records", "load_shadow_jsonl", "oracle_arrays",
           "sampled_qid", "sel_band", "wilson_interval"]
