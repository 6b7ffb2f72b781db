"""Micro-benchmark harness: measure per-route cost on the live hardware
(counterpart of ``repro.cost.calibrate``).

Runs every executor route (prefilter | graph | postfilter) over a
selectivity x N x d x k x ls grid of synthetic range-filtered datasets,
plus the streaming costs (delta scan, merge, total compaction) over a
delta_n grid. Every measurement goes through the index's
``serve.Executor``, so the timings are those of the routes serving runs:
on the card the prefilter and delta scans launch ``gather_dist_tile``.

Timing discipline (:func:`time_route`): warmup calls first, then each
repeat is timed on its own, from the call to the device's end of its work
(``torch.cuda.synchronize`` on the card; on the CPU the call returns when
its work is done), and the median repeat is reported.

The one deliberate exception: compaction is measured as ONE cold total.

``calibrate()`` is the one-call entry point: run the grid, fit the
log-linear model (``model.fit``), stamp backend/dtype/layout metadata for
the registry key. ``meta["backend"]`` is the index's torch device type
(``"cuda"`` on the card, ``"cpu"``), so ``CostRegistry.load("cuda")``
never hands the card a model measured on another backend.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import filters as F
from ..core.jag import JAGConfig, JAGIndex
from ..device import resolve_device
from ..serve.planner import match_rate
from .model import CostModel, Observation, fit

DEFAULT_SELS = (0.001, 0.01, 0.1, 0.5, 0.9)

# grid presets: FAST is the CI smoke (seconds of build time on CPU), FULL
# is a real calibration pass at serving-representative scale
FAST_GRID = dict(ns=(1500, 3000), ds=(16,), sels=DEFAULT_SELS,
                 lss=(32, 64), k=10, b=32, delta_ns=(64, 192),
                 warmup=1, repeats=2)
FULL_GRID = dict(ns=(8000, 20000), ds=(32, 64), sels=DEFAULT_SELS,
                 lss=(32, 64, 128), k=10, b=64, delta_ns=(256, 1024),
                 warmup=1, repeats=3)


def _wait() -> None:
    """Wait for the card's queued work; nothing waits where CUDA was
    never used (a CPU run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_route(fn, warmup: int = 1, repeats: int = 3):
    """(last result, median per-repeat wall seconds) of ``fn()``.

    ``warmup`` calls run (and are waited for) first; each repeat then
    times exactly one call up to the end of its device work.
    """
    res = None
    for _ in range(max(int(warmup), 0)):
        res = fn()
        _wait()
    times = []
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        res = fn()
        _wait()
        times.append(time.perf_counter() - t0)
    return res, float(np.median(times))


@dataclasses.dataclass
class Calibration:
    """Raw measurements + the grid/provenance metadata they carry."""
    observations: List[Observation]
    meta: Dict


def synth_dataset(n: int, d: int, b: int, seed: int):
    """(xb, uniform attr values, near-manifold queries) — range-filtered
    synthetic data whose selectivity is directly dialable via the hi cap.
    The reference's numpy draw, so both packages calibrate on the same
    data."""
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(n, d)).astype(np.float32)
    vals = rng.uniform(0, 1, n).astype(np.float32)
    q = (xb[rng.integers(0, n, b)]
         + 0.1 * rng.normal(size=(b, d))).astype(np.float32)
    return xb, vals, q


def _obs(route: str, res, dt: float, b: int,
         features: Dict[str, float]) -> Observation:
    return Observation(route=route, features=features,
                       us=dt / b * 1e6,
                       n_dist=float(res.n_dist.cpu().numpy().mean()))


def _selectivity(filt, table) -> np.ndarray:
    """Exact per-query selectivity f32[B] over every row of ``table``."""
    ids = torch.arange(table.n, device=table.device)
    return match_rate(F.matches_sampled(filt, table, ids)).cpu().numpy()


def run_calibration(*, ns: Sequence[int] = (2000,),
                    ds: Sequence[int] = (16,),
                    sels: Sequence[float] = DEFAULT_SELS,
                    lss: Sequence[int] = (32, 64), k: int = 10, b: int = 32,
                    delta_ns: Sequence[int] = (64, 192),
                    warmup: int = 1, repeats: int = 3, seed: int = 0,
                    cfg: Optional[JAGConfig] = None,
                    include_streaming: bool = True,
                    verbose: bool = False, device=None) -> Calibration:
    """Measure every route over the grid on ``device`` (default "cuda");
    returns raw observations.

    One index is built per (n, d) cell; base routes are measured per
    (sel[, ls]) on it, then the streaming costs (delta scan / merge /
    compaction total) per delta_n on a fresh ``StreamingJAGIndex`` wrapper
    around the largest cell's index (wrappers never mutate the base, so
    each delta_n measures from a clean slate).
    """
    from ..stream import StreamingJAGIndex

    dev = resolve_device(device)
    obs: List[Observation] = []
    builds = []
    last = None
    for n in ns:
        for d in ds:
            c = cfg or JAGConfig(degree=16, ls_build=32, batch_size=256,
                                 cand_pool=64, calib_samples=128)
            xb, vals, q = synth_dataset(n, d, b, seed)
            tab = F.range_table(vals, device=dev)
            t0 = time.time()
            index = JAGIndex.build(xb, tab, c, device=dev)
            builds.append(dict(n=n, d=d, build_s=round(time.time() - t0, 2)))
            q = torch.as_tensor(q, device=dev)
            last = (index, q, n, d)
            ex = index.executor
            for sel in sels:
                filt = F.range_filters(np.zeros(b, np.float32),
                                       np.full(b, sel, np.float32),
                                       device=dev)
                sel_true = float(_selectivity(filt, index.attr).mean())
                feat = dict(sel=sel_true, n=n, d=d, k=k, b=b, delta_n=0)
                res, dt = time_route(lambda: ex.prefilter(q, filt, k=k),
                                     warmup, repeats)
                obs.append(_obs("prefilter", res, dt, b, feat))
                for ls in lss:
                    featl = dict(feat, ls=ls)
                    res, dt = time_route(
                        lambda: ex.graph(q, filt, k=k, ls=ls,
                                         max_iters=2 * ls),
                        warmup, repeats)
                    obs.append(_obs("graph", res, dt, b, featl))
                    res, dt = time_route(
                        lambda: ex.postfilter(q, filt, k=k, ls=ls,
                                              max_iters=2 * ls),
                        warmup, repeats)
                    obs.append(_obs("postfilter", res, dt, b, featl))
                if verbose:
                    print(f"# calibrated n={n} d={d} sel={sel} "
                          f"({len(obs)} obs)", flush=True)

    if include_streaming and last is not None:
        index, q, n, d = last
        rng = np.random.default_rng(seed + 1)
        for dn in delta_ns:
            s = StreamingJAGIndex(index, compact_frac=0.0)
            xv = rng.normal(size=(dn, d)).astype(np.float32)
            dv = rng.uniform(0, 1, dn).astype(np.float32)
            s.insert(xv, F.range_table(dv, device=dev), auto_compact=False)
            filt = F.range_filters(np.zeros(b, np.float32),
                                   np.full(b, 0.5, np.float32), device=dev)
            feat = dict(sel=0.5, n=n, d=d, k=k, b=b, delta_n=dn)
            sx = s.executor
            extra, dt = time_route(lambda: sx.delta(q, filt, k=k),
                                   warmup, repeats)
            obs.append(_obs("delta", extra, dt, b, feat))
            base_res = sx.prefilter(q, filt, k=k)
            # two k points per delta_n: merge's feature vector is [1,
            # log(k)], so a single-k grid would be rank-1. merge computes
            # no distances (its result's n_dist sums its inputs'), so its
            # n_dist is 0 and merge stays uncovered under "n_dist"
            for kk in (k, 2 * k):
                # merge is tens of us: extra repeats tame the timer noise
                _, dt = time_route(
                    lambda: sx.merge(base_res, extra, k=kk), warmup,
                    max(repeats, 5))
                obs.append(Observation("merge", dict(feat, k=kk),
                                       us=dt / b * 1e6, n_dist=0.0))
            # compaction: ONE cold total, waited for on the device
            _wait()
            t0 = time.perf_counter()
            s.compact()
            _wait()
            obs.append(Observation(
                "compact", feat, us=(time.perf_counter() - t0) * 1e6))
            if verbose:
                print(f"# calibrated streaming delta_n={dn}", flush=True)

    meta = dict(backend=dev.type, dtype="f32", layout="default",
                grid=dict(ns=list(ns), ds=list(ds), sels=list(sels),
                          lss=list(lss), k=k, b=b,
                          delta_ns=list(delta_ns)),
                warmup=warmup, repeats=repeats, seed=seed, builds=builds)
    return Calibration(observations=obs, meta=meta)


def calibrate(*, fast: bool = False, meta: Optional[Dict] = None,
              device=None, **overrides) -> CostModel:
    """Grid -> measurements -> fitted :class:`CostModel`, in one call, on
    ``device`` (default "cuda").

    ``fast=True`` uses the CI smoke grid; keyword overrides replace any
    grid field. The returned model carries the registry key metadata
    (backend/dtype/layout) and per-route fit stats.
    """
    kw: Dict = dict(FAST_GRID if fast else FULL_GRID)
    kw.update(overrides)
    cal = run_calibration(device=device, **kw)
    m = dict(cal.meta)
    m.update(meta or {})
    return fit(cal.observations, m)


def calibrate_shard_grid(n: int, d: int, *, fast: bool = True,
                         meta: Optional[Dict] = None, device=None,
                         **overrides) -> CostModel:
    """One per-shard (n, d) grid entry for the sharded-serving registry:
    the base routes at exactly the per-shard row count (no streaming
    costs), stamped ``meta["shard_shape"] = [n, d]``, the key suffix
    ``CostRegistry.load_shard_grids`` groups
    :class:`~repro_torch.cost.model.InterpolatedCostModel` entries by."""
    kw: Dict = dict(FAST_GRID if fast else FULL_GRID)
    kw.update(ns=(int(n),), ds=(int(d),), include_streaming=False)
    kw.update(overrides)
    cal = run_calibration(device=device, **kw)
    m = dict(cal.meta)
    m["shard_shape"] = [int(n), int(d)]
    m.update(meta or {})
    return fit(cal.observations, m)
