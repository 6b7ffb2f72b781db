"""The port's cost model and cost routing (``repro_torch.cost``) against the
reference (``repro.cost``).

Held exactly against ``repro`` on inputs made from a numpy seed:
- ``phi``, ``fit`` and ``predict`` on the same observations (the same numpy
  code; 1e-12 relative), the JSON form byte for byte, and cross-loading;
- ``run_calibration`` on one tiny grid in both packages: the same
  observations (routes, features) with the same ``n_dist`` each, so the
  ``n_dist`` fits agree (the two builds at n = 600 are equal edge for edge);
- with one model attached to both indexes, under ``us`` and ``n_dist``
  and in per-query and batch mode: the plan's routes and ``costs``,
  ``explain``'s text and the ids (the model is fitted on the reference's
  calibration with each base route's ``us`` set to its ``n_dist``: wall
  times on a loaded CPU can put every query of the batch on one route);
- F7: an archive with a model attached, saved by ``repro`` (frozen and
  streaming), loads in the port with its model and plans and answers as
  ``repro`` does; the port's archive loads in ``repro`` with the model;
- ``compaction_break_even`` and ``delta_tax_us`` over the same inserts.

The reference's own contracts (``tests/test_cost.py``) are held within
torch: an uncalibrated index plans as the static thresholds, ``planner=``
wins over a model, cost-routed results equal each query's solo route bit
for bit, ``compact_frac <= 0`` disables compaction even with a model, and
a detached model stays detached across save and load.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import filters as RF
from repro.core.jag import JAGConfig as RConfig, JAGIndex as RIndex
from repro.cost.calibrate import run_calibration as r_run_calibration
from repro.cost.calibrate import synth_dataset
from repro.cost import model as rmodel
from repro.cost import registry as rreg
from repro.serve.planner import explain as r_explain
from repro.stream import StreamingJAGIndex as RStream
from repro_torch.core import filters as TF
from repro_torch.core.jag import JAGIndex
from repro_torch.cost import (BASE_ROUTES, CostModel, CostRegistry,
                              InterpolatedCostModel, Observation, fit,
                              from_json, phi, run_calibration, time_route,
                              to_json)
from repro_torch.cost import model as tmodel
from repro_torch.cost.model import delta_scan_tax
from repro_torch.serve.dispatch import run_route
from repro_torch.serve.planner import PlannerConfig, choose_route, explain
from repro_torch.stream import StreamingJAGIndex

torch.set_num_threads(1)

N, D, B, K, LS = 600, 16, 16, 10, 48
GRID = dict(ns=(N,), ds=(D,), sels=(0.005, 0.1, 0.9), lss=(24, 48), b=B,
            delta_ns=(30, 90), warmup=1, repeats=1)
# the calibration's own build config: its index is the one routed below
KW = dict(degree=16, ls_build=32, batch_size=256, cand_pool=64,
          calib_samples=128)


@pytest.fixture(scope="module")
def cal():
    """The tiny grid through both packages' harness, the reference's index
    over the grid's data (carried into the port) and the reference's
    measured model."""
    r = r_run_calibration(**GRID)
    t = run_calibration(device="cpu", **GRID)
    xb, vals, q = synth_dataset(N, D, B, 0)
    ridx = RIndex.build(xb, RF.range_table(vals), RConfig(**KW))
    tidx = JAGIndex.from_arrays(ridx._save_arrays(), device="cpu")
    model = rmodel.fit(r.observations, r.meta)
    # the same fit with noise-free base-route costs under "us" as well
    steady = rmodel.fit([dataclasses.replace(o, us=o.n_dist)
                         if o.route in rmodel.BASE_ROUTES else o
                         for o in r.observations], r.meta)
    return dict(r=r, t=t, ridx=ridx, tidx=tidx, q=q, vals=vals, model=model,
                steady=steady)


def _port_model(model):
    return from_json(rreg.to_json(model))


def _filters(m, **kw):
    """A mixed batch spanning the three routes' selectivities."""
    his = np.resize(np.asarray([0.005, 0.05, 0.3, 0.9], np.float32), B)
    return m.range_filters(np.zeros(B, np.float32), his, **kw)


def _rows(m, n, seed, **kw):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)).astype(np.float32),
            m.range_table(rng.uniform(0, 1, n).astype(np.float32), **kw))


def _flat(m, delta_us, compact_us):
    """Constant delta and compact predictions (zero slope)."""
    return m.CostModel(coef={"delta": {"us": [math.log(delta_us), 0.0]},
                             "compact": {"us": [math.log(compact_us), 0.0]}},
                       meta={"backend": "test"})


def _synthetic_obs(mod, seed=0):
    """Noise-free observations of a known log-linear law, per route."""
    rng = np.random.default_rng(seed)
    w_true = {"prefilter": [2.0, 0.5, 0.1, 0.3],
              "graph": [1.0, 0.8, -0.3, 0.2],
              "postfilter": [1.5, 0.7, 0.1, 0.05], "delta": [0.5, 0.9],
              "merge": [0.2, 0.3], "compact": [3.0, 1.0]}
    obs = []
    for route, w in w_true.items():
        for _ in range(24):
            f = dict(sel=float(rng.uniform(0.001, 1.0)),
                     n=int(rng.integers(500, 50000)),
                     d=int(rng.integers(8, 128)),
                     ls=int(rng.choice([32, 64, 128])), k=10,
                     delta_n=int(rng.integers(10, 1000)),
                     n_clauses=int(rng.integers(1, 5)))
            us = float(np.exp(mod.phi(route, f) @ np.asarray(w))
                       * (1.0 + 0.05 * rng.standard_normal()))
            obs.append(mod.Observation(route, f, us=us, n_dist=2.0 * us))
    return obs


def _assert_coef_close(a, b):
    assert set(a) == set(b)
    for route in a:
        assert set(a[route]) == set(b[route])
        for metric in a[route]:
            np.testing.assert_allclose(a[route][metric], b[route][metric],
                                       rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the model, its fit and its JSON: the reference's numpy code
# ---------------------------------------------------------------------------

def test_phi_fit_predict_match_reference():
    robs, tobs = _synthetic_obs(rmodel), _synthetic_obs(tmodel)
    for ro, to in zip(robs, tobs):
        np.testing.assert_allclose(phi(to.route, to.features),
                                   rmodel.phi(ro.route, ro.features),
                                   rtol=1e-12, atol=0)
    rm, tm = rmodel.fit(robs, {"backend": "cpu"}), fit(tobs,
                                                       {"backend": "cpu"})
    _assert_coef_close(tm.coef, rm.coef)
    assert tm.fit_stats.keys() == rm.fit_stats.keys()
    f = dict(sel=0.05, n=5000, d=32, ls=64, k=10, delta_n=100, n_clauses=2)
    for route in tm.routes():
        for metric in ("us", "n_dist"):
            assert math.isclose(tm.predict(route, f, metric),
                                rm.predict(route, f, metric), rel_tol=1e-12)


def test_json_byte_for_byte_and_cross_loading(cal, tmp_path):
    model = cal["model"]
    tm = _port_model(model)
    assert to_json(tm) == rreg.to_json(model)
    back = rreg.from_json(to_json(tm))
    assert back.coef == model.coef and back.meta == model.meta
    # registry files written by either package load in the other
    rreg.CostRegistry(str(tmp_path / "r")).save(model)
    got = CostRegistry(str(tmp_path / "r")).load(model.meta["backend"])
    assert to_json(got) == rreg.to_json(model)
    path = CostRegistry(str(tmp_path / "t")).save(tm)
    assert path.endswith(f"cost-{model.meta['backend']}-f32-default.json")
    got = rreg.CostRegistry(str(tmp_path / "t")).load(model.meta["backend"])
    assert got.coef == model.coef
    with pytest.raises(ValueError):
        from_json('{"schema": 2, "coef": {}}')


def test_interpolated_model_predicts_as_reference():
    def grid(mod, n, d, scale):
        return mod.CostModel(
            coef={r: {"us": [math.log(scale), 0.5, 0.1, 0.2][:len(
                mod.feature_names(r))]} for r in mod.BASE_ROUTES},
            meta={"shard_shape": [n, d]})
    rgrids = [grid(rmodel, n, 32, s) for n, s in ((1000, 1.0),
                                                  (4000, 3.0))]
    tgrids = [from_json(rreg.to_json(g)) for g in rgrids]
    ri, ti = rmodel.InterpolatedCostModel(rgrids), InterpolatedCostModel(
        tgrids)
    for n in (500, 1000, 2500, 4000, 9000):
        f = dict(sel=0.1, n=n, d=30, ls=64, k=10)
        for route in BASE_ROUTES:
            assert ti.predict(route, f) == ri.predict(route, f)


# ---------------------------------------------------------------------------
# the calibration harness on the CPU
# ---------------------------------------------------------------------------

def test_calibration_observations_and_n_dist_match_reference(cal):
    r, t = cal["r"], cal["t"]
    assert [o.route for o in t.observations] == [o.route for o in
                                                 r.observations]
    for to, ro in zip(t.observations, r.observations):
        assert to.features == ro.features, (to.route, to.features)
        assert to.n_dist == ro.n_dist, (to.route, to.features)
        assert to.us > 0 and math.isfinite(to.us)
    assert t.meta["backend"] == "cpu"
    assert {k: v for k, v in t.meta.items() if k not in ("backend",
                                                         "builds")} == \
        {k: v for k, v in r.meta.items() if k not in ("backend", "builds")}
    tm, rm = fit(t.observations, t.meta), rmodel.fit(r.observations, r.meta)
    assert tm.covers(BASE_ROUTES) and tm.covers(("delta", "merge",
                                                 "compact"))
    for route in rm.coef:
        if "n_dist" in rm.coef[route]:
            np.testing.assert_allclose(tm.coef[route]["n_dist"],
                                       rm.coef[route]["n_dist"],
                                       rtol=1e-12, atol=1e-12)
    assert tm.coef["merge"].get("n_dist") == rm.coef["merge"].get("n_dist")


def test_time_route_median_and_warmup():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(3)
    res, dt = time_route(fn, warmup=2, repeats=3)
    assert len(calls) == 5 and dt >= 0.0 and torch.equal(res,
                                                         torch.zeros(3))


# ---------------------------------------------------------------------------
# cost routing: the same model on both indexes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["per_query", "batch"])
@pytest.mark.parametrize("metric", ["us", "n_dist"])
def test_cost_routed_plan_explain_and_ids_match_reference(cal, metric,
                                                           mode):
    ridx, tidx, q = cal["ridx"], cal["tidx"], cal["q"]
    rf, tf = _filters(RF), _filters(TF, device="cpu")
    try:
        ridx.attach_cost_model(cal["steady"], metric=metric)
        tidx.attach_cost_model(_port_model(cal["steady"]), metric=metric)
        rr, rp = ridx.search_auto(q, rf, k=K, ls=LS, mode=mode,
                                  return_plan=True)
        tr, tp = tidx.search_auto(q, tf, k=K, ls=LS, mode=mode,
                                  return_plan=True)
    finally:
        ridx.attach_cost_model(None)
        tidx.attach_cost_model(None)
    assert tp.costs is not None and tp.cost_metric == metric
    assert tp.costs == rp.costs
    if mode == "per_query":
        assert tp.routes == rp.routes
        assert len(set(tp.routes)) >= 2
    else:
        assert tp.route == rp.route
    assert tp.realized == rp.realized
    assert explain(tp) == r_explain(rp)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(rr.ids))


def _plan_and_ids(ridx, tidx, q):
    rf, tf = _filters(RF), _filters(TF, device="cpu")
    rr, rp = ridx.search_auto(q, rf, k=K, ls=LS, return_plan=True)
    tr, tp = tidx.search_auto(q, tf, k=K, ls=LS, return_plan=True)
    assert tp.costs is not None and tp.costs == rp.costs
    assert tp.routes == rp.routes and tp.realized == rp.realized
    assert explain(tp) == r_explain(rp)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(rr.ids))


def test_f7_reference_archive_with_model_plans_as_reference(cal, tmp_path):
    ridx, q = cal["ridx"], cal["q"]
    path = str(tmp_path / "ref.npz")
    try:
        ridx.attach_cost_model(cal["model"], metric="n_dist")
        ridx.save(path)
    finally:
        ridx.attach_cost_model(None)
    rl = RIndex.load(path)
    tl = JAGIndex.load(path, device="cpu")
    assert tl.cost_model is not None and tl.cost_metric == "n_dist"
    assert tl.cost_model.coef == cal["model"].coef
    _plan_and_ids(rl, tl, q)


def test_f7_reference_streaming_archive_plans_as_reference(cal, tmp_path):
    ridx, q = cal["ridx"], cal["q"]
    s = RStream(ridx, compact_frac=0.5, query_horizon=777)
    s.attach_cost_model(cal["model"])
    s.insert(*_rows(RF, 40, 5), auto_compact=False)
    path = str(tmp_path / "ref_stream.npz")
    s.save(path)
    rl, tl = RStream.load(path), StreamingJAGIndex.load(path, device="cpu")
    assert tl.query_horizon == 777 and tl.cost_metric == "us"
    assert tl.cost_model is not None and tl.cost_model.coef == \
        cal["model"].coef
    assert tl.compaction_break_even() == rl.compaction_break_even()
    _plan_and_ids(rl, tl, q)
    # and the port's streaming archive back in the reference
    path2 = str(tmp_path / "port_stream.npz")
    tl.save(path2)
    back = RStream.load(path2)
    assert back.query_horizon == 777 and back.cost_model.coef == \
        cal["model"].coef
    assert back.compaction_break_even() == tl.compaction_break_even()


def test_port_archive_with_model_loads_in_reference(cal, tmp_path):
    tidx, q = cal["tidx"], cal["q"]
    path = str(tmp_path / "port.npz")
    try:
        tidx.attach_cost_model(_port_model(cal["model"]), metric="n_dist")
        tidx.save(path)
    finally:
        tidx.attach_cost_model(None)
    rl = RIndex.load(path)
    assert rl.cost_model is not None and rl.cost_metric == "n_dist"
    assert rl.cost_model.coef == cal["model"].coef
    _plan_and_ids(rl, JAGIndex.load(path, device="cpu"), q)
    # a model-free save stays model-free in both
    tidx.save(path)
    assert RIndex.load(path).cost_model is None
    assert JAGIndex.load(path, device="cpu").cost_model is None


# ---------------------------------------------------------------------------
# streaming: the compaction break-even
# ---------------------------------------------------------------------------

def test_break_even_and_delta_tax_match_reference(cal):
    ridx, tidx, q = cal["ridx"], cal["tidx"], cal["q"]
    rs = RStream(ridx, compact_frac=0.0, query_horizon=50)
    ts = StreamingJAGIndex(tidx, compact_frac=0.0, query_horizon=50)
    rs.attach_cost_model(cal["model"])
    ts.attach_cost_model(_port_model(cal["model"]))
    assert ts.compaction_break_even() == rs.compaction_break_even() == (
        0.0, 0.0, False)
    rf, tf = _filters(RF), _filters(TF, device="cpu")
    for i, m in enumerate((20, 45, 70)):
        rs.insert(*_rows(RF, m, 10 + i))
        ts.insert(*_rows(TF, m, 10 + i, device="cpu"))
        assert ts.compaction_break_even() == rs.compaction_break_even()
        assert ts.compaction_break_even(k=5) == rs.compaction_break_even(k=5)
        rr = rs.search_auto(q, rf, k=5, ls=24)
        tr = ts.search_auto(q, tf, k=5, ls=24)
        assert ts.delta_tax_us == rs.delta_tax_us > 0
        np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(rr.ids))
    # a break-even that fires compacts in both, at the same insert
    rs = RStream(ridx, compact_frac=0.9, query_horizon=1000)
    ts = StreamingJAGIndex(tidx, compact_frac=0.9, query_horizon=1000)
    rs.attach_cost_model(_flat(rmodel, 50.0, 1000.0))
    ts.attach_cost_model(from_json(rreg.to_json(_flat(rmodel, 50.0,
                                                      1000.0))))
    rrep = rs.insert(*_rows(RF, 10, 20))
    trep = ts.insert(*_rows(TF, 10, 20, device="cpu"))
    assert trep["compacted"] and rrep["compacted"]
    assert ts.delta.n == 0 and ts.n_compactions == 1


def test_delta_scan_tax_matches_reference(cal):
    tm = _port_model(cal["model"])
    for dn in (0, 30, 500, 20000):
        for metric in ("us", "n_dist"):
            kw = dict(n=N, d=D, k=K, delta_n=dn, metric=metric)
            assert delta_scan_tax(tm, **kw) == rmodel.delta_scan_tax(
                cal["model"], **kw)


# ---------------------------------------------------------------------------
# the reference's contracts, within torch
# ---------------------------------------------------------------------------

def test_uncalibrated_index_reproduces_static_plan_exactly(cal):
    tidx, q = cal["tidx"], cal["q"]
    tf = _filters(TF, device="cpu")
    assert tidx.executor.cost_router(k=K, ls=LS) is None
    want, wp = tidx.search_auto(q, tf, k=K, ls=LS, return_plan=True)
    assert wp.costs is None and wp.cost_metric is None
    cfg = PlannerConfig()
    assert wp.routes == tuple(choose_route(float(s), cfg)
                              for s in wp.selectivity)
    # a partial model (no graph or postfilter curve) counts as absent
    partial = fit([o for o in _synthetic_obs(tmodel)
                   if o.route in ("prefilter", "delta")])
    try:
        tidx.attach_cost_model(partial)
        assert tidx.executor.cost_router(k=K, ls=LS) is None
        got, gp = tidx.search_auto(q, tf, k=K, ls=LS, return_plan=True)
    finally:
        tidx.attach_cost_model(None)
    assert gp.routes == wp.routes and gp.costs is None
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_explicit_planner_wins_over_attached_model(cal):
    tidx, q = cal["tidx"], cal["q"]
    force = PlannerConfig(prefilter_max_sel=1.1, postfilter_min_sel=1.2)
    try:
        tidx.attach_cost_model(_port_model(cal["model"]))
        res, p = tidx.search_auto(q, _filters(TF, device="cpu"), k=K, ls=LS,
                                  planner=force, return_plan=True)
    finally:
        tidx.attach_cost_model(None)
    assert p.routes == ("prefilter",) * B and p.costs is None
    assert bool((res.primary[res.ids >= 0] == 0).all())


@pytest.mark.parametrize("metric", ["us", "n_dist"])
def test_cost_routed_results_equal_solo_routes(cal, metric):
    tidx, q = cal["tidx"], cal["q"]
    tf = _filters(TF, device="cpu")
    qt = torch.as_tensor(q)
    try:
        tidx.attach_cost_model(_port_model(cal["model"]), metric=metric)
        res, p = tidx.search_auto(q, tf, k=K, ls=LS, return_plan=True)
        router = tidx.executor.cost_router(k=K, ls=LS)
    finally:
        tidx.attach_cost_model(None)
    for i, s in enumerate(p.selectivity):
        costs = router.costs(float(s))
        assert p.routes[i] == min(BASE_ROUTES, key=costs.__getitem__)
        solo = run_route(tidx.executor, p.routes[i], qt[i:i + 1],
                         tf.take(np.asarray([i], np.int32)), k=K, ls=LS,
                         max_iters=2 * LS)
        # prefilter d2 low bits follow the batch on the CPU's matmul path
        # (tests/test_torch_slice.py); the card's kernel is batch-invariant
        fields = (("ids", "primary", "n_dist") if p.routes[i] == "prefilter"
                  else ("ids", "primary", "secondary", "n_dist"))
        for field in fields:
            assert torch.equal(getattr(res, field)[i],
                               getattr(solo, field)[0]), (field, i)


def test_compact_frac_zero_disables_compaction_even_calibrated(cal):
    s = StreamingJAGIndex(cal["tidx"], compact_frac=0.0,
                          query_horizon=10 ** 9)
    s.attach_cost_model(from_json(rreg.to_json(_flat(rmodel, 50.0, 1.0))))
    rep = s.insert(*_rows(TF, 10, 30, device="cpu"))
    assert s.compaction_break_even()[2]          # the break-even would fire
    assert not rep["compacted"] and s.delta.n == 10


def test_break_even_none_when_uncalibrated_falls_back_to_frac(cal):
    s = StreamingJAGIndex(cal["tidx"], compact_frac=0.05)
    assert s.compaction_break_even() is None
    assert s.insert(*_rows(TF, int(0.1 * N), 31, device="cpu"))["compacted"]


def test_detached_model_stays_detached_across_save_load(cal, tmp_path):
    s = StreamingJAGIndex(cal["tidx"], compact_frac=0.5)
    s.attach_cost_model(_port_model(cal["model"]))
    p1 = str(tmp_path / "with.npz")
    s.save(p1)
    s2 = StreamingJAGIndex.load(p1, device="cpu")
    assert s2.cost_model is not None
    s2.attach_cost_model(None)
    p2 = str(tmp_path / "detached.npz")
    s2.save(p2)
    s3 = StreamingJAGIndex.load(p2, device="cpu")
    assert s3.cost_model is None and s3.compaction_break_even() is None
    assert RStream.load(p2).cost_model is None


def test_attach_rejects_unknown_metric(cal):
    with pytest.raises(ValueError):
        cal["tidx"].attach_cost_model(CostModel({}, {}), metric="ms")
    assert Observation("merge", {}, 1.0).n_dist == 0.0
