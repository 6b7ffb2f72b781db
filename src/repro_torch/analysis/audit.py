"""Layer 2 of the port's static analysis: the route auditor (counterpart of
``repro.analysis.audit``).

Builds the reference's audit index (same data, same config) with
telemetry attached, runs every executor route once through the real
``serve.Executor`` with its ``trace_log`` armed, and replays each captured
``(key, make, args)`` under the op recorder of ``launch.trace_stats``, so
the audited closures are exactly the ones the route cache serves. The
reference reads a compiled program's HLO; PyTorch runs eagerly, so the
port reads what the replay did, and its counts are dynamic: they count
what ran, loop iterations included.

Per route it reports ``gathers_total`` (row gathers run: ``aten::index``,
``index_select``, ``gather`` and the launches of a kernel that gathers
rows), ``data_gather_operands`` (the gathered tables with N rows, by
shape), ``adjacency_gathers`` (gathers of the graph's neighbour lists:
one per traversal iteration), ``gathers_per_expansion``, ``host_syncs``,
``f64_ops``, ``collectives`` and ``n_ops``. ``gathers_per_expansion``
counts the N-row data gathers between two adjacency gathers (one loop
iteration; the seed fetch before the first is left out), a packed-row
kernel launch (``fused_expand``, ``gather_dist``) counting as one gather;
it is None for a route without traversal (scans, merges).

The contracts ``check_report`` holds:

* fused graph routes make exactly 1 gather per expansion, default-layout
  routes at least 2 (vector, norm and attribute rows: 3);
* no f64 op;
* single-device routes move nothing between devices;
* each sharded route call makes exactly S broadcasts (the query batch
  and its filter to each shard's device) and S packed gathers of
  B * (3k + 2) * 4 bytes, and nothing else crosses devices;
* host syncs per route call within ``host_sync_budget``. The scans and
  the merge make none. A traversal (graph, postfilter, unfiltered, each
  shard's) reads its all-done flag once every ``CHECK_EVERY`` iterations
  to stop early (``loop_checks``): the reference's ``while_loop`` tests
  its condition on the device, the port's host loop has to read it. Any
  further sync is a violation.

The sharded section serves a device list of 8 (``[device] * 8``: the
port fakes no devices, so no subprocess is needed) and records each
route call whole, since the merge runs outside the per-shard closures.
The recorder counts the two transfers where the code makes them, so the
count is the same on a list of distinct cards, where they move bytes.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

AUDIT_N, AUDIT_D, AUDIT_B = 256, 8, 4
AUDIT_K, AUDIT_LS, AUDIT_MI = 5, 16, 32
SHARD_DEVICES = 8
DELTA_ROWS = 32

GRAPH_VARIANTS = [("default", "f32"), ("default", "int8"),
                  ("fused", "f32"), ("fused", "int8")]
SHARDED_ROUTES = ("prefilter", "graph", "postfilter", "unfiltered")
ROW_GATHER_KERNELS = ("fused_expand", "gather_dist")
TRAVERSALS = ("graph", "postfilter", "unfiltered")


# ---------------------------------------------------------------------------
# one op record -> route statistics
# ---------------------------------------------------------------------------

def _row_gather_table(r):
    """The gathered table's spec if ``r`` gathers rows, else None."""
    from ..launch.trace_stats import GATHER_OPS
    if r.name in GATHER_OPS and r.inputs:
        return r.inputs[0]
    if r.name.startswith("kernel::") and r.inputs \
            and r.name.split("::", 1)[1] in ROW_GATHER_KERNELS:
        return r.inputs[0]
    return None


def _expansion_gathers(tables: Sequence, n_rows: int,
                       adj: str) -> Optional[int]:
    """N-row data gathers per traversal iteration: those between two
    consecutive adjacency gathers (each iteration starts with one). The
    tail after the last iteration (re-rank, filter) and the seed fetch
    before the first are not an iteration's. None without two adjacency
    gathers; if iterations differ, the largest."""
    marks = [i for i, t in enumerate(tables) if t.key == adj]
    if len(marks) < 2:
        return None
    per = [sum(1 for t in tables[a + 1:b]
               if t.shape and t.shape[0] == n_rows and t.key != adj)
           for a, b in zip(marks, marks[1:])]
    return max(per)


def analyze_record(records: Sequence, *, n_rows: int, adj: str) -> Dict:
    """Route statistics of one op record (see the module docstring)."""
    from ..launch import trace_stats as TS
    tables = [t for t in (_row_gather_table(r) for r in records)
              if t is not None]
    data_ops = Counter(t.key for t in tables
                       if t.shape and t.shape[0] == n_rows)
    return {
        "gathers_total": len(tables),
        "data_gather_operands": dict(data_ops),
        "adjacency_gathers": data_ops.get(adj, 0),
        "gathers_per_expansion": _expansion_gathers(tables, n_rows, adj),
        "host_syncs": TS.host_syncs(records),
        "f64_ops": TS.f64_ops(records),
        "collectives": TS.collective_counts(records),
        "collective_bytes": TS.collective_bytes(records),
        "kernel_launches": TS.kernel_launches(records),
        "n_ops": len(records),
    }


def loop_checks(iterations: int, max_iters: int) -> int:
    """Host reads of a traversal's all-done flag (``beam_search``): one at
    every ``CHECK_EVERY``-th iteration until the loop stops early (the
    read that stops it included) or reaches ``max_iters``."""
    from ..core.beam_search import CHECK_EVERY
    if iterations < max_iters:
        return iterations // CHECK_EVERY + 1
    return -(-max_iters // CHECK_EVERY)


def host_sync_budget(route: str, iterations: Sequence[int],
                     max_iters: int) -> int:
    """The host syncs one call of ``route`` may make: ``loop_checks`` for
    each traversal it runs (one per shard), none for a scan or merge."""
    if route.split(":")[0] not in TRAVERSALS:
        return 0
    return sum(loop_checks(it, max_iters) for it in iterations)


# ---------------------------------------------------------------------------
# route capture (through the real executor cache)
# ---------------------------------------------------------------------------

def _capture(executor, route_name: str, call: Callable) -> List[Tuple]:
    """Run ``call()`` with the executor's trace hook armed; return every
    captured (key, make, args) whose route component is ``route_name``."""
    executor.trace_log = []
    try:
        call()
        got = [e for e in executor.trace_log if e[0][0] == route_name]
        seen = [e[0] for e in executor.trace_log]
    finally:
        executor.trace_log = None
    if not got:
        raise AssertionError(f"route {route_name!r} never reached "
                             f"Executor.run; captured {seen}")
    return got


def _dataset(n: int = AUDIT_N, d: int = AUDIT_D, b: int = AUDIT_B,
             device=None):
    """The reference audit's data (numpy seed 0): rows, a range table,
    range filters [0, 0.3] and queries near rows."""
    import numpy as np
    import torch
    from ..core import filters as F
    rng = np.random.default_rng(0)
    xb = rng.normal(size=(n, d)).astype(np.float32)
    tab = F.range_table(rng.uniform(0, 1, n).astype(np.float32),
                        device=device)
    filt = F.range_filters(np.zeros(b, np.float32),
                           np.full(b, 0.3, np.float32), device=device)
    q = (xb[rng.integers(0, n, b)]
         + 0.1 * rng.normal(size=(b, d))).astype(np.float32)
    return (torch.as_tensor(xb, device=device), tab, filt,
            torch.as_tensor(q, device=device))


def _audit_device(device):
    """``resolve_device(device)`` with its index: the mesh and the report
    name the card the audit ran on (``cuda:0``, not ``cuda``)."""
    import torch
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _build_cfg():
    from ..core.jag import JAGConfig
    return JAGConfig(degree=6, ls_build=8, batch_size=128, cand_pool=16,
                     calib_samples=16, n_seeds=2)


def _route_report(name: str, captures: Sequence[Tuple], *, n_rows: int,
                  adj: str, max_iters: int, records=None) -> Dict:
    """Replay each capture under the op recorder. One capture: its record
    is the route's. Several (one per shard): gathers per expansion and
    iterations come from the replays, the rest from ``records``, the
    whole route call's."""
    from ..launch.trace_stats import record
    per = []
    for key, make, args in captures:
        _, recs = record(make(), *args)
        per.append(analyze_record(recs, n_rows=n_rows, adj=adj))
    out = dict(per[0]) if records is None else analyze_record(
        records, n_rows=n_rows, adj=adj)
    gpes = {p["gathers_per_expansion"] for p in per}
    out["gathers_per_expansion"] = max(gpes, key=lambda g: -1 if g is None
                                       else g)
    iters = [p["adjacency_gathers"] for p in per]
    out.update(key=[str(c) for c in captures[0][0]], iterations=iters,
               host_sync_budget=host_sync_budget(name, iters, max_iters))
    return out


def audit_single_device(device=None) -> Dict:
    """Audit every single-device route, layout and dtype on ``device``
    (default "cuda")."""
    import numpy as np
    import torch
    from ..core import filters as F
    from ..core.filters import as_filter
    from ..core.jag import JAGIndex
    from ..obs import Telemetry
    from ..stream import StreamingJAGIndex

    dev = _audit_device(device)
    xb, tab, filt, q = _dataset(device=dev)
    filt = as_filter(filt)
    index = JAGIndex.build(xb, tab, _build_cfg(), device=dev)
    # audited WITH telemetry attached (and exercised once): telemetry is
    # host work after each route, so every closure below must meet the
    # same budgets
    index.attach_telemetry(Telemetry())
    index.search_auto(q, filt, k=AUDIT_K, ls=AUDIT_LS)
    ex = index.executor
    n = int(index.xb.shape[0])
    from ..launch.trace_stats import spec
    adj = spec(index.graph).key
    k, ls, mi = AUDIT_K, AUDIT_LS, AUDIT_MI
    routes: Dict[str, Dict] = {}

    def audit(name, route_name, call, executor=ex, n_rows=n):
        routes[name] = _route_report(
            name, _capture(executor, route_name, call), n_rows=n_rows,
            adj=adj, max_iters=mi)

    audit("prefilter", "prefilter", lambda: ex.prefilter(q, filt, k=k))
    for introspect in (False, True):
        for layout, dtype in GRAPH_VARIANTS:
            name = f"graph:{layout}:{dtype}" + (":introspect" if introspect
                                                else "")
            audit(name, "graph",
                  lambda layout=layout, dtype=dtype, i=introspect: ex.graph(
                      q, filt, k=k, ls=ls, max_iters=mi, layout=layout,
                      dtype=dtype, introspect=i))
    audit("postfilter", "postfilter",
          lambda: ex.postfilter(q, filt, k=k, ls=ls, max_iters=mi))
    audit("unfiltered", "unfiltered",
          lambda: ex.unfiltered(q, k=k, ls=ls, max_iters=mi))

    # streaming delta + merge over a live delta segment
    rng = np.random.default_rng(1)
    stream = StreamingJAGIndex.build(xb, tab, _build_cfg(), device=dev)
    stream.attach_telemetry(Telemetry())
    stream.insert(
        torch.as_tensor(rng.normal(size=(DELTA_ROWS, AUDIT_D))
                        .astype(np.float32), device=dev),
        F.range_table(rng.uniform(0, 1, DELTA_ROWS).astype(np.float32),
                      device=dev))
    stream.search_auto(q, filt, k=k, ls=ls)
    sex = stream.executor
    base = sex.prefilter(q, filt, k=k)
    delta = sex.delta(q, filt, k=k)
    audit("delta", "delta", lambda: sex.delta(q, filt, k=k), executor=sex,
          n_rows=DELTA_ROWS)
    audit("merge", "merge", lambda: sex.merge(base, delta, k=k),
          executor=sex)
    return {
        "meta": {"n": n, "d": AUDIT_D, "b": AUDIT_B, "k": k, "ls": ls,
                 "max_iters": mi, "graph_width": int(index.graph.shape[1]),
                 "delta_n": DELTA_ROWS, "telemetry": True,
                 "device": str(dev),
                 "packed_row_width": int(
                     index.fused_layout("f32").packed.shape[1])},
        "routes": routes,
    }


def audit_sharded_routes(device=None, n_shards: int = SHARD_DEVICES
                         ) -> Dict:
    """Audit the sharded routes over the mesh ``[device] * n_shards``
    (default "cuda")."""
    from ..core.filters import as_filter
    from ..launch.trace_stats import record, spec
    from ..obs import Telemetry
    from ..serve.sharded import ShardedJAGIndex

    dev = _audit_device(device)
    xb, tab, filt, q = _dataset(n=n_shards * 40, device=dev)
    filt = as_filter(filt)
    sh = ShardedJAGIndex.build(xb, tab, _build_cfg(), mesh=[dev] * n_shards)
    sh.attach_telemetry(Telemetry())
    sh.search_auto(q, filt, k=AUDIT_K, ls=AUDIT_LS)
    ex = sh.executor
    n_loc = sh.n_loc
    adj = spec(sh.graph[0]).key
    k, ls, mi = AUDIT_K, AUDIT_LS, AUDIT_MI
    calls = {
        "prefilter": lambda: ex.prefilter(q, filt, k=k),
        "graph": lambda: ex.graph(q, filt, k=k, ls=ls, max_iters=mi),
        "postfilter": lambda: ex.postfilter(q, filt, k=k, ls=ls,
                                            max_iters=mi),
        "unfiltered": lambda: ex.unfiltered(q, k=k, ls=ls, max_iters=mi),
    }
    routes: Dict[str, Dict] = {}
    for name in SHARDED_ROUTES:
        captures = _capture(ex, name, calls[name])
        if len(captures) != n_shards:
            raise AssertionError(f"sharded {name}: {len(captures)} shard "
                                 f"closures ran, not {n_shards}")
        _, recs = record(calls[name])
        routes[name] = _route_report(name, captures, n_rows=n_loc, adj=adj,
                                     max_iters=mi, records=recs)
    return {
        "meta": {"devices": n_shards, "mesh": [str(d) for d in sh.mesh],
                 "n_loc": n_loc, "b": AUDIT_B, "k": k, "ls": ls,
                 "max_iters": mi, "telemetry": True,
                 "merge_payload_bytes": AUDIT_B * (3 * k + 2) * 4},
        "routes": routes,
    }


def audit_stamp(device=None) -> Dict:
    """Compact per-route facts for stamping into a benchmark's artifacts,
    so performance numbers travel with the gather and sync counts they
    were measured under."""
    return {name: {"gathers": r["gathers_total"],
                   "gathers_per_expansion": r["gathers_per_expansion"],
                   "host_syncs": r["host_syncs"],
                   "collectives": r["collectives"]}
            for name, r in audit_single_device(device)["routes"].items()}


def run_audit(device=None, sharded: bool = True) -> Dict:
    """The full audit on ``device`` (default "cuda"; raises without a
    GPU): the single-device routes, then the sharded ones over
    ``[device] * SHARD_DEVICES``. Returns the report, its
    ``violations`` included."""
    dev = _audit_device(device)
    report = {"backend": dev.type, **audit_single_device(dev)}
    if sharded:
        report["sharded"] = audit_sharded_routes(dev)
    report["violations"] = check_report(report)
    return report


# ---------------------------------------------------------------------------
# the contracts
# ---------------------------------------------------------------------------

def check_report(report: Dict) -> List[str]:
    """Every contract the audit holds, as human-readable violations (an
    empty list: all hold)."""
    out: List[str] = []
    for name, r in report.get("routes", {}).items():
        if r["f64_ops"]:
            out.append(f"{name}: {r['f64_ops']} f64 op(s)")
        if r["collectives"]:
            out.append(f"{name}: single-device route moves data between "
                       f"devices {r['collectives']}")
        if r["host_syncs"] > r["host_sync_budget"]:
            out.append(f"{name}: {r['host_syncs']} host syncs, budget "
                       f"{r['host_sync_budget']} (iterations "
                       f"{r['iterations']})")
        gpe = r.get("gathers_per_expansion")
        if name.startswith("graph:fused") and gpe != 1:
            out.append(f"{name}: {gpe} gathers per expansion (fused "
                       f"contract is exactly 1)")
        if name.startswith("graph:default") and (gpe is None or gpe < 2):
            out.append(f"{name}: expansion gather count {gpe}: the split "
                       f"layout fetches >= 2 operands, so the record is "
                       f"miscounted")
    sh = report.get("sharded")
    if sh:
        S = sh["meta"]["devices"]
        payload = sh["meta"]["merge_payload_bytes"]
        for name, r in sh.get("routes", {}).items():
            if r["f64_ops"]:
                out.append(f"sharded/{name}: {r['f64_ops']} f64 op(s)")
            if r["host_syncs"] > r["host_sync_budget"]:
                out.append(f"sharded/{name}: {r['host_syncs']} host syncs, "
                           f"budget {r['host_sync_budget']}")
            if r["collectives"] != {"broadcast": S, "packed_gather": S} \
                    or r["collective_bytes"].get("packed_gather") != \
                    S * payload:
                out.append(
                    f"sharded/{name}: collectives {r['collectives']} "
                    f"({r['collective_bytes']} bytes): the route must send "
                    f"the queries to each of {S} shards and merge exactly "
                    f"{S} packed payloads of {payload} bytes, and nothing "
                    f"else")
    return out


def format_report(report: Dict) -> List[str]:
    """The audit's output lines: one per route, the violations, a
    summary."""
    lines = []
    for name, r in report["routes"].items():
        lines.append(f"audit,{name},gathers={r['gathers_total']},"
                     f"gpe={r['gathers_per_expansion']},"
                     f"syncs={r['host_syncs']}/{r['host_sync_budget']},"
                     f"iterations={r['iterations']},"
                     f"collectives={sum(r['collectives'].values())}")
    for name, r in report.get("sharded", {}).get("routes", {}).items():
        lines.append(f"audit,sharded/{name},gathers={r['gathers_total']},"
                     f"gpe={r['gathers_per_expansion']},"
                     f"syncs={r['host_syncs']}/{r['host_sync_budget']},"
                     f"collectives={r['collectives']}")
    lines += [f"VIOLATION: {v}" for v in report["violations"]]
    lines.append(f"# jagcheck audit on {report['meta']['device']}: "
                 f"{len(report['violations'])} violation(s)")
    return lines
