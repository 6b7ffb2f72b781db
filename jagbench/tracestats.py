"""Device-trace arithmetic of the benchmark.

``profile_stats`` is a frozen copy of the port's
``repro_torch.launch.trace_stats.profile_stats``: the union of device
events over the host's wall clock, the idle gaps, the host's syncs and the
kernels by name. ``idle_by_host_op`` and ``short_name`` are the
benchmark's own: they name each idle stretch of the device by what the
host was doing in it, and shorten kernel names to what the ledger can
carry.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def profile_stats(events: Sequence[dict], wall_us: Optional[float] = None,
                  gaps: int = 5) -> dict:
    """Statistics of a Chrome trace's ``traceEvents`` (what
    ``torch.profiler``'s ``export_chrome_trace`` writes).

    Device work is the complete ("X") events of the kernel, memcpy and
    memset categories. ``device_busy_us`` is the length of their union,
    ``device_busy_share`` its share of ``wall_us`` (the host's clock
    around the run; default the trace's own span). ``idle_gaps_us`` are
    the longest stretches of the trace's span with no device work, the
    span's head and tail included. ``runtime_syncs`` counts the host's
    ``cuda*Synchronize`` calls, ``dtoh_copies`` the device-to-host
    copies, and ``idle_at_syncs_us`` sums the idle stretches in which a
    sync returned: the device drained its queue while the host waited,
    and stays idle until the host enqueues again. ``kernels`` maps kernel
    names to their calls and device ms, the most device time first.
    """
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                 for e in xs if e.get("cat") in DEVICE_CATS)
    if xs:
        t0 = min(float(e["ts"]) for e in xs)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    else:
        t0 = t1 = 0.0
    busy, idle, cur_s, cur_e = 0.0, [], None, t0
    for s, e, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            idle.append((cur_e if cur_s is not None else t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    idle.append((cur_e if cur_s is not None else t0, t1))
    syncs = [float(e["ts"]) + float(e["dur"]) for e in xs
             if e.get("cat") == "cuda_runtime"
             and "Synchronize" in e.get("name", "")]
    at_syncs = [g for g in idle if any(g[0] <= t < g[1] for t in syncs)]
    kern: Dict[str, List[float]] = {}
    for s, e, ev in dev:
        if ev.get("cat") == "kernel":
            k = kern.setdefault(ev["name"], [0, 0.0])
            k[0] += 1
            k[1] += e - s
    rows = sorted(kern.items(), key=lambda kv: -kv[1][1])
    wall = (t1 - t0) if wall_us is None else wall_us
    return {
        "wall_us": wall,
        "device_busy_us": busy,
        "device_busy_share": busy / wall if wall > 0 else 0.0,
        "kernel_launches": sum(v[0] for v in kern.values()),
        "kernels": {name: {"calls": v[0], "device_ms": v[1] / 1e3}
                    for name, v in rows},
        "idle_gaps_us": sorted((b - a for a, b in idle if b > a),
                               reverse=True)[:gaps],
        "idle_us": sum(b - a for a, b in idle),
        "idle_at_syncs_us": sum(b - a for a, b in at_syncs),
        "runtime_syncs": len(syncs),
        "dtoh_copies": sum(1 for e in xs if e.get("cat") == "gpu_memcpy"
                           and "DtoH" in e.get("name", "")),
    }


def short_name(kernel: str) -> str:
    """A kernel's name without ``void``, namespaces, template arguments
    and parameters: ``void at::native::(anonymous namespace)::
    indexSelectLargeIndex<float, ...>(...)`` -> ``indexSelectLargeIndex``."""
    name = re.sub(r"^void\s+", "", kernel.strip())
    depth, out = 0, []
    for ch in name:              # drop everything inside <...> and (...)
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    name = "".join(out).strip()
    name = name.split("::")[-1].strip() or kernel[:64]
    return re.sub(r"\s+", "_", name)[:64]


def device_ops(stats: dict, top: int = 10) -> List[Tuple[str, float]]:
    """The kernels that took most device time, by short name, in
    seconds."""
    by: Dict[str, float] = {}
    for name, row in stats["kernels"].items():
        s = short_name(name)
        by[s] = by.get(s, 0.0) + row["device_ms"] / 1e3
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def idle_intervals(events: Sequence[dict]) -> List[Tuple[float, float]]:
    """The stretches (start, end) in us of the trace's span with no device
    work, as ``profile_stats`` finds them."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not xs:
        return []
    t0 = min(float(e["ts"]) for e in xs)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in xs if e.get("cat") in DEVICE_CATS)
    out, cur = [], t0
    for s, e in dev:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def idle_by_host_op(events: Sequence[dict],
                    top: int = 10) -> List[Tuple[str, float]]:
    """Idle device time in seconds by what the host was doing: each idle
    stretch goes to the innermost host op (an aten op or a
    ``record_function`` span) of the busiest host thread running at its
    midpoint, or to ``python`` where none runs (the interpreter between
    ops)."""
    ops = [e for e in events if e.get("ph") == "X" and "dur" in e
           and e.get("cat") in HOST_CATS]
    tids: Dict[object, int] = {}
    for e in ops:
        tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    main = max(tids, key=tids.get) if tids else None
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?")) for e in ops if e.get("tid") == main)
    gaps = sorted(idle_intervals(events), key=lambda g: g[0] + g[1])
    by: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in gaps:                 # midpoints in increasing order
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:   # ended: never covers again
            stack.pop()
        # the latest start still running at mid is the innermost op
        name = stack[-1][2] if stack else "python"
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]
