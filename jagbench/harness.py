"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

Closed loop, one client: the client sends a batch of queries with their
filters, waits until the batch's ids and distances are on the host, and
sends the next. Set-up draws a pool of ``pool`` distinct batches from the
seed and the window cycles through them. Every answer of the window is
compared with the reference once the window has closed.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from jagbench import reference, tracestats
from jagbench.catalog import Catalog

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the numbers compared, each against its limit; ``recall_miss`` (1 minus
# the window's recall) only in cells with a limit of their own for it
CHECKS = ("bad_ids", "empty_answers", "dist_gap", "rank_gap", "recall_miss")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not load (the JAX
    package and JAX), compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Client:
    """The cell's index and its pool of batches; ``serve(j)`` sends pool
    batch ``j`` through ``search_auto`` and waits for its answers on the
    host."""

    def __init__(self, idx, kind, cfg, traffic, data, device):
        self.idx, self.kind, self.cfg, self.device = idx, kind, cfg, device
        self.search = dict(traffic["search"])
        B, P = traffic["batch"], traffic["pool"]
        self.queries = [torch.from_numpy(data["queries"][j * B:(j + 1) * B])
                        for j in range(P)]
        self.filters = [data["filters"][j * B:(j + 1) * B] for j in range(P)]

    def serve(self, j: int, on_group: Optional[Callable] = None):
        filt = self.kind.program_filters(self.filters[j], self.cfg,
                                         self.device)
        res, plan = self.idx.search_auto(self.queries[j], filt,
                                         return_plan=True, on_group=on_group,
                                         **self.search)
        return (res.ids.cpu().numpy(), res.primary.cpu().numpy(),
                res.secondary.cpu().numpy(), plan.routes)


def _profile(client: Client, batches: List[int], device, outs: list):
    """``batches`` served under ``torch.profiler`` (plain calls, as in the
    untraced window); returns the trace's statistics, the breakdown and
    the queries each profiled batch sent to the exact scan."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    scanned = []
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j in batches:
            # an idle stretch inside no aten op is the host's Python
            with record_function("python:search_auto"):
                out = client.serve(j)
            outs.append((j, out))
            scanned.append(int(np.sum(np.asarray(out[3]) == "prefilter")))
        _sync(device)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="jagbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.remove(path)
    stats = tracestats.profile_stats(events, wall * 1e6)
    return dict(stats=stats, wall_s=wall, scanned=scanned,
                device_ops=tracestats.device_ops(stats),
                idle_gaps=tracestats.idle_by_host_op(events))


def run_cell(cat: Catalog, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             log: Callable[[str], None] = lambda s: None) -> dict:
    """One run; returns the result line's object (``correct`` first,
    ``checks`` last)."""
    from repro_torch.core.jag import JAGConfig, JAGIndex

    cell = cat.workload(workload)
    cfg = cat.config(cell["config"])
    traffic = cat.traffic(cell["traffic"])
    if traffic["filter"] != cfg["kind"]:
        raise ValueError(f"traffic {cell['traffic']} sends {traffic['filter']}"
                         f" filters to a {cfg['kind']} configuration")
    kind = cat.kind(cfg["kind"])
    limits = cat.limits(workload)
    rng_seed = int(seed) % (1 << 64)

    data = kind.generate(cfg, traffic, rng_seed)
    log(f"data: {cfg['n']} rows, d {cfg['d']}, pool {traffic['pool']} x "
        f"{traffic['batch']} queries ({time.perf_counter() - t_start:.1f} s)")
    xb = torch.as_tensor(data["xb"], device=device)
    table = kind.program_table(data, cfg, device)
    _sync(device)
    t0 = time.perf_counter()
    jcfg = JAGConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in cfg["index"].items()})
    idx = JAGIndex.build(xb, table, jcfg, device=device)
    _sync(device)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s")
    client = Client(idx, kind, cfg, traffic, data, device)
    for j in range(traffic["warmup_batches"]):
        client.serve(j % traffic["pool"])
    _sync(device)
    # what set-up left behind stays out of the window's collections
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.2f} s")

    # the measured window: closed loop through the pool
    outs, batch_s, groups = [], [], []
    P = traffic["pool"]
    i = 0
    tw = time.perf_counter()
    while True:
        j = i % P
        got: list = []
        og = (lambda g, r, st, s: got.append((g.route, int(g.ids.size), s))
              ) if trace else None
        tb = time.perf_counter()
        out = client.serve(j, on_group=og)
        te = time.perf_counter()
        outs.append((j, out))
        batch_s.append(te - tb)
        groups.append(got)
        i += 1
        if te - tw >= seconds:
            break
    window_s = te - tw
    q = np.percentile(np.asarray(batch_s) * 1e3, [0, 25, 50, 75, 100])
    log(f"window: {i} batches in {window_s:.3f} s; batch ms min/q1/median/"
        f"q3/max {' '.join(f'{v:.1f}' for v in q)}")
    log("batch ms by pool batch: " + " ".join(
        f"{j}:{t * 1e3:.0f}" for (j, _), t in zip(outs, batch_s)))
    prof = None
    if trace:
        first = i % P
        prof = _profile(client, [(first + t) % P
                                 for t in range(traffic["trace_batches"])],
                        device, outs)
        log(f"traced: {traffic['trace_batches']} batches in "
            f"{prof['wall_s']:.3f} s")
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del client, idx, table, xb
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison: every answer, each distinct one judged once
    tr = time.perf_counter()
    judge = reference.Judge(reference.Reference(kind, data, device,
                                                k=traffic["search"]["k"]),
                            data["queries"], data["filters"],
                            traffic["batch"])
    distinct: Dict[tuple, list] = {}
    for j, (ids, prim, sec, routes) in outs:
        h = hashlib.sha1()
        for a in (ids, prim, sec):
            h.update(a.tobytes())
        h.update(repr(routes).encode())
        key = (j, h.digest())
        if key in distinct:
            distinct[key][1] += 1
        else:
            distinct[key] = [(j, ids, prim, sec, routes), 1]
    verdicts, counts = [], []
    for (j, ids, prim, sec, routes), c in distinct.values():
        scanned = np.asarray(routes) == "prefilter"
        verdicts.append(judge.judge(j, ids, prim, sec, scanned))
        counts.append(c)
    nums = reference.summarize(verdicts, counts)
    failed = reference.failed_queries(verdicts, counts, limits)
    log(f"reference: {len(distinct)} distinct answers of {len(outs)} "
        f"batches judged in {time.perf_counter() - tr:.2f} s")

    B = traffic["batch"]
    run = SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, setup_s=setup_s,
        build_s=build_s, window_s=window_s, batch_s=batch_s,
        batch_queries=[B] * len(batch_s), recall=nums["recall"],
        groups=groups if trace else None, prof=prof, n=cfg["n"],
        d=cfg["d"], words=kind.attr_words(cfg))
    metrics = {}
    for m in cat.metrics_of(workload, trace):
        v = cat.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {name: {"value": nums[name], "limit": limits[name]}
              for name in CHECKS if name in nums and name in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": B * len(outs),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = prof["stats"]["device_busy_us"] / 1e6
        dev["window_s"] = prof["wall_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in prof["device_ops"]],
            "idle_gaps": [[n, s] for n, s in prof["idle_gaps"]]}
    result["checks"] = checks
    return result
