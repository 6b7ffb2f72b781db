"""The port's serving telemetry (``repro_torch.obs``) and introspective
traversal against the reference (``repro.obs``).

One frozen index is built with ``repro`` (N = 400, degree 6) and carried
into the port with ``from_arrays``; both packages then serve the same
calls with the same telemetry attached. Held against ``repro``:
- ``TraversalStats`` (hops, sat_step, dead_ends) per query, on the
  default and fused layouts, with ids equal;
- the ``TraceRecord`` of every served query, all fields but ``ts`` and
  ``observed_us`` (wall time), frozen and streaming, per-query and batch;
- ``detect_drift``, ``recalibrate`` and ``heldout_error`` on one trace
  window; the shadow auditor's recall tables on the same sampled queries;
  ``health_report`` on the same records;
- the JSONL dumps: the port's load in the reference's ``load_jsonl`` and
  in ``tools/jagstat.py``, whose summary of a port dump equals that of the
  reference's dump of the same calls but for the wall-time columns.

Within torch: introspection leaves ids and keys bitwise unchanged and is
a cache-key component, ``miss_hook`` fires once per key, an epoch roll
fires ``roll_hook``, spans cover the pipeline (and a streaming index's
delta scan and merge), and a streaming index audits its merged result
once.
"""
import importlib.util
import json
import os
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from repro.core import filters as RF
from repro.core.jag import JAGConfig, JAGIndex as RIndex
from repro.cost import model as rmodel
from repro.cost import registry as rreg
from repro.obs import Telemetry as RTelemetry
from repro.obs import drift as rdrift
from repro.obs import health as rhealth
from repro.obs import recal as rrecal
from repro.obs import trace as rtrace
from repro.obs.introspect import (introspection_summary as
                                  r_introspection_summary)
from repro.obs.shadow import ShadowRecord as RShadowRecord
from repro.serve.planner import explain as r_explain
from repro.stream import StreamingJAGIndex as RStream
from repro_torch.core import filters as TF
from repro_torch.core.beam_search import TraversalStats
from repro_torch.core.jag import JAGIndex
from repro_torch.cost.model import BASE_ROUTES
from repro_torch.cost.registry import from_json
from repro_torch.obs import (ShadowAuditor, SpanRecorder, Telemetry,
                             TraceBuffer, TraceRecord, detect_drift,
                             health_report, heldout_error,
                             introspection_summary, load_jsonl,
                             recalibrate, render_health, stats_to_host)
from repro_torch.obs.shadow import sampled_qid
from repro_torch.serve.planner import explain
from repro_torch.stream import StreamingJAGIndex

torch.set_num_threads(1)

N, D, B = 400, 8, 8
CFG = JAGConfig(degree=6, ls_build=8, batch_size=128, cand_pool=16,
                calib_samples=16, n_seeds=2)
SKIP = ("ts", "observed_us")          # wall-clock fields


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    xb = rng.normal(size=(N, D)).astype(np.float32)
    vals = rng.uniform(0, 1, N).astype(np.float32)
    q = (xb[rng.integers(0, N, B)]
         + 0.05 * rng.normal(size=(B, D))).astype(np.float32)
    ridx = RIndex.build(xb, RF.range_table(vals), CFG)
    tidx = JAGIndex.from_arrays(ridx._save_arrays(), device="cpu")
    return ridx, tidx, q


def _filt(m, sel=None, **kw):
    """A uniform batch at ``sel``, or the mixed 0.01 / 0.9 batch."""
    his = (np.where(np.arange(B) % 2 == 0, 0.01, 0.9) if sel is None
           else np.full(B, sel))
    return m.as_filter(m.range_filters(np.zeros(B, np.float32),
                                       his.astype(np.float32), **kw))


def _both(sel=None):
    return _filt(RF, sel), _filt(TF, sel, device="cpu")


def _toy_model():
    """A reference model whose costs lie exactly in phi's span (the one
    ``tests/test_obs.py`` builds)."""
    def cost(route, f):
        if route == "prefilter":
            return 0.002 * (f["n"] * f["d"]) * f["sel"] ** 0.5
        if route == "graph":
            return (0.3 * (f["ls"] * f["d"]) ** 0.8 * f["sel"] ** -0.2
                    * f["n"] ** 0.1)
        return (0.1 * (f["ls"] * f["d"]) ** 0.9 * f["n"] ** 0.05
                * f["sel"] ** 0.3)
    obs = []
    for n in (300.0, 600.0, 1200.0):
        for sel in (0.001, 0.01, 0.1, 0.5, 0.9):
            f = dict(sel=sel, n=n, d=8.0, k=5.0, ls=16.0, n_clauses=1.0)
            for route in rmodel.BASE_ROUTES:
                us = cost(route, f)
                obs.append(rmodel.Observation(route, f, us=us, n_dist=us))
    return rmodel.fit(obs, {"source": "toy"})


def _rows(m, n, seed, **kw):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)).astype(np.float32),
            m.range_table(rng.uniform(0, 1, n).astype(np.float32), **kw))


def _fields(rec):
    return {k: v for k, v in asdict(rec).items() if k not in SKIP}


def _assert_traces_equal(tt, rt):
    assert len(tt) == len(rt) > 0
    for a, b in zip(tt, rt):
        assert _fields(a) == _fields(b)
        assert a.observed_us > 0


def _as_ref(records):
    return [rtrace.TraceRecord(**asdict(r)) for r in records]


# ---------------------------------------------------------------------------
# traversal introspection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["default", "fused"])
def test_traversal_stats_match_reference(pair, layout):
    ridx, tidx, q = pair
    rf, tf = _both(0.4)
    rres, rst = ridx.executor.graph(q, rf, k=3, ls=8, max_iters=16,
                                    layout=layout, introspect=True)
    tres, tst = tidx.executor.graph(torch.as_tensor(q), tf, k=3, ls=8,
                                    max_iters=16, layout=layout,
                                    introspect=True)
    assert isinstance(tst, TraversalStats)
    for f in ("hops", "sat_step", "dead_ends"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(rst, f)), err_msg=f)
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(rres.ids))
    assert torch.equal(tst.hops, tres.n_expanded)
    host = stats_to_host(tst)
    assert host["dead_ends"].dtype == np.int64
    assert (host["dead_ends"] <= host["hops"]).all()


@pytest.mark.parametrize("layout,dtype", [("default", "f32"),
                                          ("fused", "f32"),
                                          ("default", "int8"),
                                          ("fused", "int8")])
def test_introspection_leaves_ids_and_keys_bitwise(pair, layout, dtype):
    _, tidx, q = pair
    q = torch.as_tensor(q)
    tf = _filt(TF, 0.4, device="cpu")
    ex = tidx.executor
    std = ex.graph(q, tf, k=3, ls=8, max_iters=16, layout=layout,
                   dtype=dtype)
    res, st = ex.graph(q, tf, k=3, ls=8, max_iters=16, layout=layout,
                       dtype=dtype, introspect=True)
    for f in std._fields:
        assert torch.equal(getattr(res, f), getattr(std, f)), f
    assert torch.equal(st.hops, std.n_expanded)
    assert bool((st.sat_step <= st.hops).all())


def test_introspect_is_a_cache_key_and_misses_fire_once(pair):
    _, tidx, q = pair
    q = torch.as_tensor(q)
    ex = tidx.executor
    misses = []
    ex.miss_hook = misses.append
    try:
        tf = _filt(TF, 0.4, device="cpu")
        ex.graph(q, tf, k=3, ls=11, max_iters=16)          # fresh key
        ex.graph(q, tf, k=3, ls=11, max_iters=16, introspect=True)
        assert len(misses) == 2
        assert any("introspect" in key for key in misses)
        ex.graph(q, tf, k=3, ls=11, max_iters=16, introspect=True)
        ex.graph(q, tf, k=3, ls=11, max_iters=16)
        assert len(misses) == 2                             # warm
        ex.graph(q, tf, k=4, ls=11, max_iters=16)
        assert len(misses) == 3 and len(set(misses)) == 3
        assert all(key[0] == ex._cache_epoch and key in ex._cache
                   for key in misses)
    finally:
        ex.miss_hook = None


def test_epoch_roll_fires_roll_hook(pair):
    _, tidx, q = pair
    stream = StreamingJAGIndex(tidx, compact_frac=10.0)
    tel = stream.attach_telemetry()
    tf = _filt(TF, 0.4, device="cpu")
    stream.search_auto(q, tf, k=3, ls=8)
    assert tel.metrics.value("jag_epoch_roll_total") == 0
    m0 = tel.jit_misses()
    assert m0 > 0
    stream.insert(*_rows(TF, 16, 7, device="cpu"))
    stream.search_auto(q, tf, k=3, ls=8)
    assert tel.metrics.value("jag_epoch_roll_total") == 1
    assert tel.jit_misses() > m0
    assert tel.delta_scan_fraction() > 0
    assert all(t.route.endswith("+delta") and t.delta_n == 16
               for t in list(tel.traces)[-B:])
    stream.compact()
    assert tel.metrics.value("jag_compaction_total") == 1


# ---------------------------------------------------------------------------
# traces: the reference's records, query for query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["per_query", "batch"])
def test_trace_records_match_reference(pair, mode):
    ridx, tidx, q = pair
    model = _toy_model()
    ridx.attach_cost_model(model)
    tidx.attach_cost_model(from_json(rreg.to_json(model)))
    rt = ridx.attach_telemetry(RTelemetry(introspect=True))
    tt = tidx.attach_telemetry(Telemetry(introspect=True))
    try:
        for sel in (None, 0.4, 0.05):
            rf, tf = _both(sel)
            rr, rp = ridx.search_auto(q, rf, k=3, ls=8, mode=mode,
                                      return_plan=True, layout="fused")
            tr, tp = tidx.search_auto(q, tf, k=3, ls=8, mode=mode,
                                      return_plan=True, layout="fused")
            np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(rr.ids))
            assert explain(tp) == r_explain(rp)
    finally:
        for idx in (ridx, tidx):
            idx.attach_telemetry(None)
            idx.attach_cost_model(None)
    _assert_traces_equal(list(tt.traces), list(rt.traces))
    assert len(tt.traces) == 3 * B
    assert all(r.predicted is not None and r.cost_metric == "us"
               for r in tt.traces)
    assert introspection_summary(list(tt.traces)) == \
        r_introspection_summary(list(rt.traces))
    assert tt.metrics.value("jag_search_total") == 3
    assert tt.metrics.counter_total("jag_route_query_total") == 3 * B


def test_streaming_traces_and_spans_match_reference(pair):
    ridx, tidx, q = pair
    rs, ts = RStream(ridx, compact_frac=10.0), StreamingJAGIndex(
        tidx, compact_frac=10.0)
    rt = rs.attach_telemetry(RTelemetry(introspect=True, spans=True))
    tt = ts.attach_telemetry(Telemetry(introspect=True, spans=True))
    rs.insert(*_rows(RF, 16, 5))
    ts.insert(*_rows(TF, 16, 5, device="cpu"))
    rf, tf = _both()
    rr, rp = rs.search_auto(q, rf, k=3, ls=8, return_plan=True)
    tr, tp = ts.search_auto(q, tf, k=3, ls=8, return_plan=True)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(rr.ids))
    assert tp.realized == rp.realized and explain(tp) == r_explain(rp)
    _assert_traces_equal(list(tt.traces), list(rt.traces))
    names = [s.name for s in tt.spans.spans]
    assert names == [s.name for s in rt.spans.spans]
    assert "delta" in names and "merge" in names
    (delta,) = [s for s in tt.spans.spans if s.name == "delta"]
    assert delta.args.get("rows") == 16
    (top,) = [s for s in tt.spans.spans if s.name == "search_auto"]
    ex = [s for s in tt.spans.spans if s.name.startswith("execute:")]
    assert ex and all(s.depth >= 1 for s in ex)
    assert sum(s.duration_us for s in ex) <= top.duration_us


def test_detach_and_disabled_telemetry_stop_tracing(pair):
    _, tidx, q = pair
    tf = _filt(TF, device="cpu")
    tel = tidx.attach_telemetry()
    tidx.search_auto(q, tf, k=3, ls=8)
    n0 = len(tel.traces)
    assert n0 == B and tidx.executor.miss_hook is not None
    assert tidx.attach_telemetry(None) is None
    tidx.search_auto(q, tf, k=3, ls=8)
    assert len(tel.traces) == n0 and tidx.executor.miss_hook is None
    tel2 = tidx.attach_telemetry(Telemetry(enabled=False))
    tidx.search_auto(q, tf, k=3, ls=8)
    assert len(tel2.traces) == 0
    tidx.attach_telemetry(None)


def test_on_group_takes_stats_and_seconds(pair):
    _, tidx, q = pair
    seen = []
    tel = tidx.attach_telemetry(Telemetry(introspect=True))
    try:
        res, p = tidx.search_auto(
            q, _filt(TF, device="cpu"), k=3, ls=8, return_plan=True,
            on_group=lambda g, r, st, s: seen.append((g.route, st, s)))
    finally:
        tidx.attach_telemetry(None)
    assert [r for r, _, _ in seen] == [g.route for g in p.groups]
    for route, st, s in seen:
        assert s > 0 and (st is None) == (route != "graph")
    seen.clear()
    tidx.search_auto(q, _filt(TF, 0.4, device="cpu"), k=3, ls=8,
                     mode="batch",
                     on_group=lambda g, r, st, s: seen.append((g, st)))
    (g, st), = seen
    assert g.route == "graph" and st is None and g.ids.size == B


# ---------------------------------------------------------------------------
# drift, recalibration, shadow recall and health on the same inputs
# ---------------------------------------------------------------------------

def _window(model, scale, n_traces=240, bands=None, seed=0):
    """Port traces whose observed cost is ``scale`` x the prediction."""
    rng = np.random.default_rng(seed)
    sweep = (0.001, 0.003, 0.01, 0.05, 0.1, 0.3, 0.5, 0.7, 0.9)
    out = []
    for i in range(n_traces):
        sel = sweep[i % len(sweep)]
        f = dict(sel=sel, n=2000.0, d=8.0, k=5.0, ls=16.0, n_clauses=1.0)
        pred = {r: model.predict(r, f) for r in BASE_ROUTES}
        band = bands[i % len(bands)] if bands else min(pred, key=pred.get)
        obs = pred[band] * scale * (1.0 + 0.02 * rng.standard_normal())
        out.append(TraceRecord(
            qid=i, ts=0.0, epoch=0, band=band, route=band, group=0,
            group_size=1, batch=1, mode="batch", sel=sel, k=5, ls=16,
            n=2000, d=8, n_clauses=1, delta_n=0, shard=None,
            predicted=pred, cost_metric="us", observed_us=float(obs),
            n_dist=int(obs) + 1, n_expanded=5))
    return out


@pytest.mark.parametrize("scale,bands", [(3.0, BASE_ROUTES),
                                         (3.0, ("graph",)), (1.0, None)])
def test_drift_recalibrate_heldout_match_reference(scale, bands):
    rm = _toy_model()
    tm = from_json(rreg.to_json(rm))
    window = _window(tm, scale, bands=bands)
    rwin = _as_ref(window)
    td, rd = detect_drift(window), rdrift.detect_drift(rwin)
    assert (td.median_rel_err, td.drifted, td.n_traces) == \
        (rd.median_rel_err, rd.drifted, rd.n_traces)
    assert heldout_error(tm, window) == rrecal.heldout_error(rm, rwin)
    tr = recalibrate(tm, window, metric="us", min_traces=32)
    rr = rrecal.recalibrate(rm, rwin, metric="us", min_traces=32)
    assert (tr.swapped, tr.reason, tr.stale_err, tr.refit_err, tr.n_train,
            tr.n_holdout) == (rr.swapped, rr.reason, rr.stale_err,
                              rr.refit_err, rr.n_train, rr.n_holdout)
    assert tr.model.coef == rr.model.coef
    assert tr.swapped == (scale != 1.0)


def test_maybe_recalibrate_attaches_on_swap(pair):
    _, tidx, _ = pair
    stale = from_json(rreg.to_json(_toy_model()))
    tidx.attach_cost_model(stale)
    tel = tidx.attach_telemetry(Telemetry(drift_threshold=0.5))
    try:
        for t in _window(stale, 3.0, n_traces=128):
            tel.traces.append(t)
        rep = tel.maybe_recalibrate(tidx)
        assert rep.swapped and tidx.cost_model is rep.model
        assert tel.metrics.value("jag_recal_swap_total") == 1
    finally:
        tidx.attach_telemetry(None)
        tidx.attach_cost_model(None)
    rep = Telemetry().maybe_recalibrate(tidx)
    assert not rep.swapped and rep.reason == "no cost model attached"


def test_shadow_recall_tables_and_health_match_reference(pair):
    ridx, tidx, q = pair
    rt = ridx.attach_telemetry(RTelemetry(shadow=0.5, introspect=True))
    tt = tidx.attach_telemetry(Telemetry(shadow=0.5, introspect=True))
    try:
        for sel in (0.05, 0.4, 0.9, None):
            rf, tf = _both(sel)
            ridx.search_auto(q, rf, k=3, ls=8)
            tidx.search_auto(q, tf, k=3, ls=8)
        assert tt.shadow.n_pending > 0 and tt.shadow.n_audited == 0
        table = tt.shadow.recall_table()
    finally:
        ridx.attach_telemetry(None)
        tidx.attach_telemetry(None)
    assert table == rt.shadow.recall_table()
    assert sorted(r.qid for r in tt.shadow.records) == \
        [i for i in range(4 * B) if sampled_qid(i, 0.5)]
    for a, b in zip(tt.shadow.records, rt.shadow.records):
        assert {k: v for k, v in asdict(a).items() if k != "ts"} == \
            {k: v for k, v in asdict(b).items() if k != "ts"}
    assert tt.metrics.value("jag_shadow_audit_total") == tt.shadow.n_audited
    # health on the same records: the port's traces and audits
    traces, shadow = list(tt.traces), list(tt.shadow.records)
    rshadow = [RShadowRecord(**asdict(s)) for s in shadow]
    got = health_report(traces, shadow)
    want = rhealth.health_report(_as_ref(traces), rshadow)
    assert got == want
    assert render_health(got) == rhealth.render_health(want)
    assert "shadow recall" in render_health(tt.health_report())


def test_streaming_shadow_audits_merged_result_once(pair):
    _, tidx, q = pair
    stream = StreamingJAGIndex(tidx, compact_frac=10.0)
    tel = stream.attach_telemetry(Telemetry(shadow=1.0))
    stream.insert(*_rows(TF, 16, 3, device="cpu"))
    stream.search_auto(q, _filt(TF, 0.4, device="cpu"), k=3, ls=8)
    tel.shadow.flush()
    assert tel.shadow.n_audited == B
    assert all(route.endswith("+delta") for route, _, _ in tel.shadow.cells)
    assert all(c.trials > 0 for c in tel.shadow.cells.values())


def test_streaming_shadow_snapshot_references_segments(pair):
    """A pending audit holds the base and delta tensors themselves, not a
    copy of their concatenation; rows appended before the flush stay out
    of it."""
    _, tidx, q = pair
    f = _filt(TF, 0.4, device="cpu")

    def audited(insert_before_flush):
        stream = StreamingJAGIndex(tidx, compact_frac=10.0)
        tel = stream.attach_telemetry(Telemetry(shadow=1.0))
        stream.insert(*_rows(TF, 16, 3, device="cpu"))
        stream.search_auto(q, f, k=3, ls=8)
        (e,) = tel.shadow._pending
        assert len(e.parts) == 2 and e.parts[0] is tidx.xb
        assert e.parts[1] is stream.delta_arrays()[0]
        if insert_before_flush:
            stream.insert(*_rows(TF, 16, 4, device="cpu"))
        return tel.shadow.recall_table()

    assert audited(True) == audited(False)


def test_dropped_index_frees_without_the_cycle_collector(pair):
    """The executor and its route closures hold the index weakly, so the
    last reference to an index that has served every route frees it."""
    import gc
    import weakref
    _, tidx, q = pair
    f = _filt(TF, device="cpu")
    gc.collect()
    gc.disable()
    try:
        idx = JAGIndex.from_arrays(tidx._save_arrays(), device="cpu")
        idx.attach_telemetry(Telemetry(introspect=True, spans=True,
                                       shadow=0.5))
        for layout in ("default", "fused"):
            idx.search_auto(q, f, k=3, ls=8, layout=layout)
            idx.search_auto(q, f, k=3, ls=8, layout=layout, mode="batch")
        idx.search_int8(q, f, k=3, ls=8)
        idx.search_unfiltered(q, k=3, ls=8)
        stream = StreamingJAGIndex(idx, compact_frac=10.0)
        stream.attach_telemetry(Telemetry(introspect=True, shadow=0.5))
        stream.insert(*_rows(TF, 16, 3, device="cpu"))
        stream.search_auto(q, f, k=3, ls=8, layout="fused")
        refs = weakref.ref(idx), weakref.ref(stream)
        del idx, stream
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_shadow_vacuous_filter_counts_no_trials(pair):
    from repro_torch.core.beam_search import SearchResult
    _, tidx, q = pair
    aud = ShadowAuditor(1.0)
    empty = TF.as_filter(TF.range_filters(np.full(B, 0.9, np.float32),
                                          np.full(B, 0.1, np.float32),
                                          device="cpu"))
    res = SearchResult(torch.full((B, 3), -1, dtype=torch.int32),
                       torch.full((B, 3), float("inf")),
                       torch.full((B, 3), float("inf")),
                       torch.full((B, 4), -1, dtype=torch.int32),
                       torch.zeros(B, dtype=torch.int32),
                       torch.zeros(B, dtype=torch.int32))
    aud.audit(tidx, q, empty, res, k=3, qid0=0, routes=["prefilter"] * B,
              sels=np.zeros(B))
    aud.flush()
    (cell,) = aud.cells.values()
    assert cell.trials == 0 and cell.n_queries == B and cell.estimate == 1.0


# ---------------------------------------------------------------------------
# dumps: JSONL and the Chrome trace in the reference's formats
# ---------------------------------------------------------------------------

def _jagstat():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "jagstat.py")
    spec = importlib.util.spec_from_file_location("jagstat", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dumps_load_in_reference_and_jagstat(pair, tmp_path, capsys):
    ridx, tidx, q = pair
    model = _toy_model()
    ridx.attach_cost_model(model)
    tidx.attach_cost_model(from_json(rreg.to_json(model)))
    rt = ridx.attach_telemetry(RTelemetry(shadow=1.0, introspect=True))
    tt = tidx.attach_telemetry(Telemetry(shadow=1.0, introspect=True))
    try:
        for sel in (None, 0.4):
            rf, tf = _both(sel)
            ridx.search_auto(q, rf, k=3, ls=8)
            tidx.search_auto(q, tf, k=3, ls=8)
    finally:
        for idx in (ridx, tidx):
            idx.attach_telemetry(None)
            idx.attach_cost_model(None)
    paths = {}
    for name, tel in (("t", tt), ("r", rt)):
        paths[name] = (str(tmp_path / f"{name}_traces.jsonl"),
                       str(tmp_path / f"{name}_shadow.jsonl"))
        assert tel.traces.dump_jsonl(paths[name][0]) == 2 * B
        assert tel.shadow.dump_jsonl(paths[name][1]) == 2 * B
    back = rtrace.load_jsonl(paths["t"][0])
    assert [asdict(r) for r in back] == [asdict(r) for r in tt.traces]
    assert [asdict(r) for r in load_jsonl(paths["r"][0])] == \
        [asdict(r) for r in rt.traces]
    jagstat = _jagstat()
    wall = ("p50_us", "p95_us", "p99_us", "rel_err", "drift")
    rows = {}
    for name in ("t", "r"):
        assert jagstat.main([paths[name][0]]) == 0
        assert "route" in capsys.readouterr().out
        rows[name] = [{k: v for k, v in r.items() if k not in wall}
                      for r in jagstat.summarize(load_jsonl(paths[name][0]))]
    assert rows["t"] == rows["r"]
    docs = {}
    for name in ("t", "r"):
        jagstat.main([paths[name][0], "--health", "--shadow",
                      paths[name][1], "--slo-recall", "0.05", "--json"])
        docs[name] = json.loads(capsys.readouterr().out)
    for section in ("shadow_recall", "dead_ends"):
        assert docs["t"][section] == docs["r"][section]
    assert docs["t"]["n_traces"] == docs["r"]["n_traces"] == 2 * B


def test_span_recorder_chrome_export_and_bound(tmp_path):
    sr = SpanRecorder()
    with sr.span("outer", batch=2):
        with sr.span("inner"):
            pass
    assert [s.name for s in sr.spans] == ["inner", "outer"]
    path = str(tmp_path / "trace.json")
    assert sr.export_chrome_trace(path) == 2
    events = json.load(open(path))["traceEvents"]
    assert all(e["ph"] == "X" and e["cat"] == "serve" for e in events)
    assert {e["name"]: e for e in events}["inner"]["args"]["parent"] == \
        "outer"
    small = SpanRecorder(capacity=3)
    for i in range(7):
        with small.span(f"s{i}"):
            pass
    assert [s.name for s in small.spans] == ["s4", "s5", "s6"]
    assert small.dropped == 4


def test_trace_buffer_ring_and_jsonl(tmp_path):
    rec = _window(from_json(rreg.to_json(_toy_model())), 1.0, n_traces=1)[0]
    buf = TraceBuffer(capacity=4)
    for i in range(6):
        buf.append(replace(rec, qid=i))
    assert [r.qid for r in buf] == [2, 3, 4, 5] and buf.dropped == 2
    path = str(tmp_path / "ring.jsonl")
    buf.dump_jsonl(path)
    assert [r.qid for r in rtrace.load_jsonl(path)] == [2, 3, 4, 5]
