"""Sharded serving on the port (``repro_torch.serve.sharded``,
``repro_torch.core.distributed``) against the reference's
``repro.serve.sharded`` and ``repro.core.distributed``.

The port's mesh is a list of devices in one process; here ``[cpu] * S``
stands for the reference's faked host devices, so no subprocess is needed.
The indexes are built by the port (cheap on the CPU) and carried into the
reference with ``repro.core.jag.JAGIndex._from_npz`` over the port's
``_save_arrays()``, so both packages serve the same rows and graphs. Held:
- S = 1 (N = 400): the sharded ``search_auto`` under the force-prefilter
  planner equals the port's own index on every field and the reference's
  index (ids and counts exactly, d2 allclose), all four kinds and a
  compound expression; the graph, postfilter and unfiltered routes equal
  the single index but for the width-0 vlog;
- S = 8 (N = 320): the same forced-prefilter equality against the
  reference's union index and the port's own union index, both dispatch
  modes. On the CPU it is bitwise against the port's union too: each
  shard's scan pads its 40 rows to the same 4096-row block as the union's
  320, so the block products have one shape;
- the graph route at S = 8 equals the reference's per-shard searches,
  ids globalized and merged in shard order by ``repro.serve.dispatch.
  fold_topk``;
- validation errors, one packed gather per shard per route, cost routing
  at the per-shard shape, telemetry (introspection refused, the shadow
  oracle's shard-major rows);
- ``make_serve_step`` at S = 8 with query_chunk 8 (recall above 0.75, ids
  equal to the reference's per-shard steps merged as it merges), the
  int8_reg chunking invariance, and ``make_build_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as RF
from repro.core.distributed import (ShardedServeConfig as RServeConfig,
                                    make_serve_step as r_make_serve_step)
from repro.core.jag import JAGIndex as RIndex
from repro.launch.mesh import mesh_kwargs, set_mesh
from repro.serve.dispatch import fold_topk as r_fold_topk
from repro.serve.planner import PlannerConfig as RPlannerConfig
from repro_torch.core import build as TB
from repro_torch.core import filters as TF
from repro_torch.core.distributed import (ShardedServeConfig,
                                          make_build_step, make_serve_step)
from repro_torch.core.jag import JAGConfig, JAGIndex
from repro_torch.core.quantized import quantize_int8
from repro_torch.distributed.sharding import put_db_sharded, serve_mesh
from repro_torch.obs import Telemetry
from repro_torch.obs.shadow import oracle_arrays
from repro_torch.serve import ShardedJAGIndex, shard_index
from repro_torch.serve import sharded as SH
from repro_torch.serve.planner import PlannerConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
N, D, B = 400, 8, 6
CFG = JAGConfig(degree=10, ls_build=16, batch_size=128, cand_pool=32,
                calib_samples=32, n_seeds=4)
N8, S8 = 320, 8
CFG8 = JAGConfig(degree=6, ls_build=8, batch_size=128, cand_pool=16,
                 calib_samples=16, n_seeds=2)
# the force-exact planner: prefilter everywhere, in both packages
FORCE = dict(prefilter_max_sel=1.1, postfilter_min_sel=1.2)
FORCE_PRE = PlannerConfig(**FORCE)
FORCE_GRAPH = PlannerConfig(prefilter_max_sel=0.0, postfilter_min_sel=1.2)
KINDS = ("range", "label", "subset", "boolean")
FIELDS = ("ids", "primary", "secondary", "vlog", "n_expanded", "n_dist")


def _arrays(kind, rng, n, b):
    """numpy attribute rows and filter lanes of one kind (mid-band
    selectivity), the reference test's draws."""
    if kind == "range":
        return (rng.uniform(0, 1, n).astype(np.float32),
                (np.zeros(b, np.float32), np.full(b, 0.2, np.float32)))
    if kind == "label":
        return rng.integers(0, 5, n).astype(np.int32), np.full(b, 2)
    if kind == "subset":
        fb = np.zeros((b, 16), bool)
        fb[:, :3] = True
        return rng.random((n, 16)) < 0.5, fb
    sat = np.zeros((b, 1 << 8), bool)
    for i in range(b):
        sat[i, rng.choice(1 << 8, 64, replace=False)] = True
    return rng.integers(0, 1 << 8, n).astype(np.uint32), sat


def _table(m, kind, rows, **kw):
    if kind == "range":
        return m.range_table(rows, **kw)
    if kind == "label":
        return m.label_table(rows, **kw)
    if kind == "subset":
        return m.subset_table(rows, 16, **kw)
    return m.boolean_table(rows, 8, **kw)


def _filters(m, kind, lanes, **kw):
    if kind == "range":
        return m.range_filters(*lanes, **kw)
    if kind == "label":
        return m.label_filters(lanes, **kw)
    if kind == "subset":
        return m.subset_filters(lanes, 16, **kw)
    return m.boolean_filters(lanes, 8, **kw)


def _compound(m, rng, n, b, **kw):
    labels = rng.integers(0, 4, n).astype(np.int32)
    vals = rng.uniform(0, 1, n).astype(np.float32)
    tab = m.joint_table(m.label_table(labels, **kw),
                        m.range_table(vals, **kw))
    expr = ((m.Label(np.full(b, 2), **kw) | m.Label(np.full(b, 3), **kw))
            & m.Range(np.zeros(b, np.float32), np.full(b, 0.7, np.float32),
                      **kw))
    return tab, expr


@dataclasses.dataclass
class Case:
    xb: np.ndarray
    q: np.ndarray
    ttab: object
    tfilt: object
    rfilt: object
    tidx: JAGIndex          # the port's index over every row
    ridx: RIndex            # the same index carried into the reference


def _case(kind, n, cfg, seed):
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(n, D)).astype(np.float32)
    if kind == "compound":
        rs = rng.bit_generator.state
        _, rfilt = _compound(RF, rng, n, B)
        rng.bit_generator.state = rs
        ttab, tfilt = _compound(TF, rng, n, B, device="cpu")
    else:
        rows, lanes = _arrays(kind, rng, n, B)
        ttab = _table(TF, kind, rows, device="cpu")
        tfilt = _filters(TF, kind, lanes, device="cpu")
        rfilt = _filters(RF, kind, lanes)
    q = (xb[rng.integers(0, n, B)]
         + 0.1 * rng.normal(size=(B, D))).astype(np.float32)
    tidx = JAGIndex.build(xb, ttab, cfg, device="cpu")
    ridx = RIndex._from_npz(tidx._save_arrays())
    return Case(xb, q, ttab, tfilt, rfilt, tidx, ridx)


_CASES = {}


def case1(kind):
    """S = 1, N = 400: the index and its one-shard sharded form."""
    if kind not in _CASES:
        c = _case(kind, N, CFG, 11 + KINDS.index(kind)
                  if kind in KINDS else 7)
        _CASES[kind] = (c, ShardedJAGIndex.from_shards([c.tidx],
                                                       mesh=[CPU]))
    return _CASES[kind]


def case8(kind):
    """S = 8 on [cpu] * 8, N = 320: the union index and the sharded build
    over the same rows."""
    key = ("s8", kind)
    if key not in _CASES:
        c = _case(kind, N8, CFG8, 21 + KINDS.index(kind)
                  if kind in KINDS else 27)
        _CASES[key] = (c, ShardedJAGIndex.build(c.xb, c.ttab, CFG8,
                                                mesh=[CPU] * S8))
    return _CASES[key]


def _same(got, want, fields=FIELDS):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert torch.equal(a, b), f


def _like_reference(got, want):
    """ids and counts exactly, primary exactly, d2 allclose; vlog shape."""
    for f in ("ids", "primary", "n_expanded", "n_dist"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.secondary.numpy(),
                               np.asarray(want.secondary), rtol=1e-5,
                               atol=1e-5)
    assert tuple(got.vlog.shape) == np.asarray(want.vlog).shape


# ---------------------------------------------------------------------------
# S = 1: the sharded surface over one shard equals the single index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS + ("compound",))
def test_s1_search_auto_exact_route(kind):
    c, sh = case1(kind)
    got = sh.search_auto(c.q, c.tfilt, k=10, ls=32, planner=FORCE_PRE)
    _same(got, c.tidx.search_auto(c.q, c.tfilt, k=10, ls=32,
                                  planner=FORCE_PRE))
    _like_reference(got, c.ridx.search_auto(
        c.q, c.rfilt, k=10, ls=32, planner=RPlannerConfig(**FORCE)))


def test_s1_graph_route_parity():
    c, sh = case1("range")
    got = sh.search(c.q, c.tfilt, k=10, ls=32)
    want = c.tidx.search(c.q, c.tfilt, k=10, ls=32)
    _same(got, want, ("ids", "primary", "secondary", "n_expanded",
                      "n_dist"))
    assert tuple(got.vlog.shape) == (B, 0)
    r = c.ridx.search(c.q, c.rfilt, k=10, ls=32)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(r.ids))
    np.testing.assert_array_equal(got.n_dist.numpy(), np.asarray(r.n_dist))


def test_s1_postfilter_route_parity():
    c, sh = case1("range")
    wide = TF.range_filters(np.zeros(B, np.float32),
                            np.full(B, 0.95, np.float32), device="cpu")
    got = sh.executor.postfilter(torch.as_tensor(c.q), wide, k=10, ls=32,
                                 max_iters=64)
    want = c.tidx.executor.postfilter(torch.as_tensor(c.q), wide, k=10,
                                      ls=32, max_iters=64)
    _same(got, want, ("ids", "primary", "secondary", "n_expanded",
                      "n_dist"))
    r = c.ridx.executor.postfilter(
        jnp.asarray(c.q), RF.range_filters(np.zeros(B, np.float32),
                                           np.full(B, 0.95, np.float32)),
        k=10, ls=32, max_iters=64)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(r.ids))


def test_shard_convenience_and_unfiltered():
    c, _ = case1("range")
    sh = c.tidx.shard(1, mesh=[CPU])       # a rebuild over the same rows
    assert isinstance(sh, ShardedJAGIndex) and sh.n_shards == 1
    got = sh.executor.unfiltered(torch.as_tensor(c.q), k=10, ls=32,
                                 max_iters=64)
    want = c.tidx.search_unfiltered(c.q, k=10, ls=32, max_iters=64)
    _same(got, want, ("ids", "primary", "secondary"))
    assert shard_index(c.tidx, 1, mesh=[CPU]).n_shards == 1
    with pytest.raises(ValueError, match="devices"):
        c.tidx.shard(1)                    # no visible CUDA device here


# ---------------------------------------------------------------------------
# S = 8 in one process: the exact route equals the union index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS + ("compound",))
def test_s8_exact_route_equals_union(kind):
    c, sh = case8(kind)
    assert sh.n_shards == S8 and sh.n_loc == N8 // S8
    for mode in ("per_query", "batch"):
        got = sh.search_auto(c.q, c.tfilt, k=10, ls=16, planner=FORCE_PRE,
                             mode=mode)
        _like_reference(got, c.ridx.search_auto(
            c.q, c.rfilt, k=10, ls=16, planner=RPlannerConfig(**FORCE),
            mode=mode))
        _same(got, c.tidx.search_auto(c.q, c.tfilt, k=10, ls=16,
                                      planner=FORCE_PRE, mode=mode))


@pytest.mark.parametrize("kind", ("range", "subset"))
def test_s8_graph_route_equals_reference_shards_merged(kind):
    c, _ = case8(kind)
    n_loc = N8 // S8
    shards = []
    for s in range(S8):
        rows = slice(s * n_loc, (s + 1) * n_loc)
        sub = TF.AttrTable(c.ttab.kind, {k: v[rows] for k, v in
                                         c.ttab.data.items()},
                           c.ttab.n_bits)
        shards.append(JAGIndex.build(c.xb[rows], sub, CFG8, device="cpu"))
    sh = ShardedJAGIndex.from_shards(shards, mesh=[CPU] * S8)
    got = sh.search(c.q, c.tfilt, k=10, ls=16)
    parts = []
    for s, t in enumerate(shards):
        r = RIndex._from_npz(t._save_arrays()).search(c.q, c.rfilt, k=10,
                                                      ls=16)
        parts.append(r._replace(
            ids=jnp.where(r.ids >= 0, r.ids + s * n_loc, -1),
            vlog=jnp.zeros((B, 0), jnp.int32)))
    want = r_fold_topk(parts, k=10)
    _like_reference(got, want)
    # the same shards' rows are the sharded build's
    again = ShardedJAGIndex.build(c.xb, c.ttab, CFG8, mesh=[CPU] * S8)
    _same(again.search(c.q, c.tfilt, k=10, ls=16), got)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _small(n, seed=0, kind="range"):
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(n, 4)).astype(np.float32)
    if kind == "range":
        tab = TF.range_table(rng.uniform(0, 1, n).astype(np.float32),
                             device="cpu")
    else:
        tab = TF.label_table(rng.integers(0, 3, n), device="cpu")
    return xb, tab


def test_build_validation():
    xb, tab = _small(30)
    with pytest.raises(ValueError, match="pass n_shards"):
        ShardedJAGIndex.build(xb, tab, CFG8)
    with pytest.raises(ValueError, match="devices"):
        ShardedJAGIndex.build(xb, tab, CFG8, n_shards=3)
    with pytest.raises(ValueError, match="split evenly"):
        ShardedJAGIndex.build(xb, tab, CFG8, mesh=[CPU] * 8)
    with pytest.raises(ValueError, match="devices"):
        serve_mesh(2)


def test_from_shards_validation():
    mk = lambda n, seed, kind="range": JAGIndex.build(  # noqa: E731
        *_small(n, seed, kind), CFG8, device="cpu")
    a, b, c = mk(20, 1), mk(30, 2), mk(20, 3, "label")
    with pytest.raises(ValueError, match="at least one"):
        ShardedJAGIndex.from_shards([])
    with pytest.raises(ValueError, match="same row count"):
        ShardedJAGIndex.from_shards([a, b], mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="one attr schema"):
        ShardedJAGIndex.from_shards([a, c], mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="carry 2 shards but the mesh"):
        ShardedJAGIndex.from_shards([a, mk(20, 4)], mesh=[CPU] * 3)
    with pytest.raises(ValueError, match="union attr table has"):
        ShardedJAGIndex(mesh=[CPU], graph=[a.graph], xb=[a.xb],
                        xb_norm=[a.xb_norm],
                        attr_data={"value": [a.attr.data["value"]]},
                        entry=[a.entry], attr=b.attr, cfg=CFG8)
    with pytest.raises(ValueError, match="3 shards for a mesh of 2"):
        put_db_sharded([a.xb] * 3, [CPU] * 2)


def test_shards_hold_their_rows_without_a_union_copy():
    c, sh = case8("range")
    n_loc = N8 // S8
    for s in range(S8):
        assert torch.equal(sh.xb[s], torch.as_tensor(
            c.xb[s * n_loc:(s + 1) * n_loc]))
        assert sh.xb[s].shape == (n_loc, D)
    adopted = ShardedJAGIndex.from_shards([c.tidx], mesh=[CPU])
    # one shard adopts the index's own tensors
    assert adopted.xb[0].data_ptr() == c.tidx.xb.data_ptr()
    assert adopted.graph[0].data_ptr() == c.tidx.graph.data_ptr()


def test_dropped_sharded_index_is_freed_without_the_cycle_collector():
    """The executor and its route closures hold no shard tensor and the
    index only weakly, so dropping the index frees it at once."""
    import gc
    import weakref
    xb, tab = _small(40, seed=5)
    sh = ShardedJAGIndex.build(xb, tab, CFG8, mesh=[CPU] * 4)
    q = torch.as_tensor(xb[:3])
    filt = TF.range_filters(np.zeros(3, np.float32),
                            np.ones(3, np.float32), device="cpu")
    sh.search_auto(q, filt, k=5, ls=8)
    sh.search_auto(q, filt, k=5, ls=8, planner=FORCE_PRE)
    ex, gone = sh.executor, weakref.ref(sh)
    was = gc.isenabled()
    gc.disable()
    try:
        del sh
        assert gone() is None
    finally:
        if was:
            gc.enable()
    with pytest.raises(ReferenceError):
        ex.graph(q, filt, k=5, ls=8, max_iters=16)


# ---------------------------------------------------------------------------
# the merge: one packed gather per shard per route
# ---------------------------------------------------------------------------

def test_one_packed_gather_per_shard_per_route():
    c, sh = case8("label")
    q = torch.as_tensor(c.q)
    k = 10
    per = B * (3 * k + 2) * 4
    for run in (lambda: sh.executor.prefilter(q, c.tfilt, k=k),
                lambda: sh.executor.graph(q, c.tfilt, k=k, ls=16,
                                          max_iters=32),
                lambda: sh.executor.postfilter(q, c.tfilt, k=k, ls=16,
                                               max_iters=32),
                lambda: sh.executor.unfiltered(q, k=k, ls=16, max_iters=32)):
        SH.reset_gathers()
        run()
        assert SH.GATHERS == {"transfers": S8, "bytes": S8 * per}
    # one route call per planned group
    SH.reset_gathers()
    _, p = sh.search_auto(c.q, c.tfilt, k=k, ls=16, return_plan=True)
    assert SH.GATHERS["transfers"] == S8 * len(p.groups)


# ---------------------------------------------------------------------------
# cost routing at the per-shard shape
# ---------------------------------------------------------------------------

def _grid_model(n, d, scale=1.0):
    from repro_torch.cost import CostModel, Observation, fit, phi
    rng = np.random.default_rng(int(n))
    obs = []
    for route, w in (("prefilter", [2.0, 0.5, 0.1, 0.3]),
                     ("graph", [1.0 * scale, 0.8, -0.3, 0.2]),
                     ("postfilter", [1.5, 0.7, 0.1, 0.05])):
        for _ in range(12):
            f = dict(sel=float(rng.uniform(0.01, 1.0)), n=n, d=d,
                     ls=int(rng.choice([32, 64])), k=10, n_clauses=1)
            obs.append(Observation(route, f,
                                   us=float(np.exp(phi(route, f)
                                                   @ np.asarray(w)))))
    m = fit(obs, dict(backend="cpu", shard_shape=[int(n), int(d)]))
    assert isinstance(m, CostModel)
    return m


@pytest.mark.parametrize("which", ("s1", "s8"))
def test_sharded_cost_router_predicts_at_per_shard_shape(which):
    from repro_torch.cost import InterpolatedCostModel
    c, sh = case1("range") if which == "s1" else case8("range")
    model = InterpolatedCostModel([_grid_model(20, D),
                                   _grid_model(10000, D)])
    sh.attach_cost_model(model)
    try:
        r = sh.executor.cost_router(k=10, ls=32)
        assert r is not None
        assert r.n == sh.n_loc and r.d == D      # per-shard rows, not N
        assert r.route(0.5) in ("prefilter", "graph", "postfilter")
        res = sh.search_auto(c.q, c.tfilt, k=10, ls=32)
        assert tuple(res.ids.shape) == (B, 10)
    finally:
        sh.attach_cost_model(None)
    assert sh.executor.cost_router(k=10, ls=32) is None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_sharded_routes_refuse_introspection_and_other_layouts():
    c, sh = case8("range")
    q = torch.as_tensor(c.q)
    with pytest.raises(NotImplementedError, match="introspection"):
        sh.executor.graph(q, c.tfilt, k=10, ls=16, max_iters=32,
                          introspect=True)
    for layout, dtype in (("fused", "f32"), ("default", "int8")):
        with pytest.raises(NotImplementedError, match="only"):
            sh.executor.graph(q, c.tfilt, k=10, ls=16, max_iters=32,
                              layout=layout, dtype=dtype)
    sh.attach_telemetry(Telemetry(introspect=True))
    try:
        with pytest.raises(NotImplementedError, match="introspection"):
            sh.search_auto(c.q, c.tfilt, k=10, ls=16, planner=FORCE_GRAPH)
    finally:
        sh.attach_telemetry(None)


@pytest.mark.parametrize("kind", ("range", "boolean"))
def test_shadow_oracle_uses_shard_major_rows(kind):
    c, sh = case8(kind)
    xb, attr = oracle_arrays(sh)
    assert torch.equal(xb, torch.as_tensor(c.xb))
    assert attr.n == N8
    tel = sh.attach_telemetry(Telemetry(shadow=1.0))
    try:
        sh.search_auto(c.q, c.tfilt, k=10, ls=16, planner=FORCE_PRE)
        sh.search_auto(c.q, c.tfilt, k=10, ls=16, planner=FORCE_GRAPH)
        rows = {r["route"]: r for r in tel.shadow.recall_table()}
        assert rows["prefilter"]["recall"] == 1.0
        assert rows["prefilter"]["n_queries"] == B
        assert 0.0 <= rows["graph"]["recall"] <= 1.0
        assert tel.traces and all(t.n == N8 // S8 for t in tel.traces)
    finally:
        sh.attach_telemetry(None)


# ---------------------------------------------------------------------------
# make_serve_step and make_build_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_shards():
    """8 shards of 300 rows (range attributes), built by the port: the
    reference test's sizes and config."""
    rng = np.random.default_rng(0)
    S, n_loc, d = 8, 300, 8
    xb = rng.normal(size=(S, n_loc, d)).astype(np.float32)
    vals = rng.uniform(0, 100, (S, n_loc)).astype(np.float32)
    cfg = JAGConfig(degree=10, ls_build=16, batch_size=128, cand_pool=48)
    graphs, entries = [], []
    for s in range(S):
        idx = JAGIndex.build(xb[s], TF.range_table(vals[s], device="cpu"),
                             cfg, device="cpu")
        graphs.append(idx.graph.numpy())
        entries.append(np.resize(idx.entry.numpy(), 4))
    xbn = (xb.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    q = rng.normal(size=(16, d)).astype(np.float32)
    lo = rng.uniform(0, 90, 16).astype(np.float32)
    return dict(graphs=np.stack(graphs), entries=np.stack(entries).astype(
        np.int32), xb=xb, xbn=xbn, vals=vals, q=q, lo=lo)


def _step_args(a, s=None):
    """The step's arguments (all shards, or shard s alone) as tensors."""
    pick = (lambda x: x) if s is None else (lambda x: x[s:s + 1])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(pick(x)))  # noqa
    return (t(a["graphs"]), t(a["xb"]), t(a["xbn"]), {"value": t(a["vals"])},
            t(a["entries"]), torch.from_numpy(a["q"]),
            {"lo": torch.from_numpy(a["lo"]),
             "hi": torch.from_numpy(a["lo"] + 10)})


def test_make_serve_step_recall_and_reference_ids(serve_shards):
    a = serve_shards
    cfg = ShardedServeConfig(k=5, ls=24, max_iters=48, query_chunk=8)
    step = make_serve_step([CPU] * 8, cfg, "range", "range")
    ids, prim, sec = (x.numpy() for x in step(*_step_args(a)))
    S, n_loc, d = a["xb"].shape
    xf, vf, q, lo = a["xb"].reshape(-1, d), a["vals"].reshape(-1), a["q"], \
        a["lo"]
    d2 = ((q[:, None] - xf[None]) ** 2).sum(-1)
    mask = (vf[None] >= lo[:, None]) & (vf[None] <= (lo + 10)[:, None])
    d2m = np.where(mask, d2, np.inf)
    recs = []
    for b in range(q.shape[0]):
        gt = [j for j in np.argsort(d2m[b])[:5] if d2m[b, j] < np.inf]
        got = [i for i, p in zip(ids[b], prim[b]) if p == 0 and i >= 0]
        if gt:
            recs.append(len(set(gt) & set(got)) / len(gt))
    assert float(np.mean(recs)) > 0.75, np.mean(recs)

    # the reference's step on each shard alone, merged as it merges
    mesh = jax.make_mesh((1, 1), ("data", "model"), **mesh_kwargs(2))
    r_step = jax.jit(r_make_serve_step(mesh, RServeConfig(
        k=5, ls=24, max_iters=48, query_chunk=8), "range", "range"))
    ri, rp, rs = [], [], []
    with set_mesh(mesh):
        for s in range(S):
            g, x, xn, ad, e, qq, fd = _step_args(a, s)
            i_, p_, s_ = r_step(jnp.asarray(g.numpy()), jnp.asarray(
                x.numpy()), jnp.asarray(xn.numpy()),
                {"value": jnp.asarray(ad["value"].numpy())},
                jnp.asarray(e.numpy()), jnp.asarray(a["q"]),
                {"lo": jnp.asarray(a["lo"]), "hi": jnp.asarray(a["lo"] + 10)})
            ri.append(jnp.where(i_ >= 0, i_ + s * n_loc, -1))
            rp.append(p_)
            rs.append(s_)
    p_, s_, i_ = jax.lax.sort((jnp.concatenate(rp, 1),
                               jnp.concatenate(rs, 1),
                               jnp.concatenate(ri, 1)), num_keys=2)
    np.testing.assert_array_equal(ids, np.asarray(i_[:, :5]))
    np.testing.assert_array_equal(prim, np.asarray(p_[:, :5]))
    np.testing.assert_allclose(sec, np.asarray(s_[:, :5]), rtol=1e-5,
                               atol=1e-5)


def test_int8_reg_dist_batch_invariance():
    """int8_reg computes q.x with gathered_dot, so per-query results are
    bitwise identical across query_chunk regroupings (one 16-query chunk
    against two of 8)."""
    rng = np.random.default_rng(3)
    n, d, Bq = 240, 8, 16
    xb = rng.normal(size=(n, d)).astype(np.float32)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    idx = JAGIndex.build(xb, TF.range_table(vals, device="cpu"),
                         JAGConfig(degree=10, ls_build=16, batch_size=128,
                                   cand_pool=48), device="cpu")
    xq, scale = quantize_int8(idx.xb)
    q = torch.from_numpy(rng.normal(size=(Bq, d)).astype(np.float32))
    lo = torch.from_numpy(rng.uniform(0, 90, Bq).astype(np.float32))
    args = ([idx.graph], [xq], [idx.xb_norm],
            {"value": [torch.from_numpy(vals)]},
            [torch.from_numpy(np.resize(idx.entry.numpy(), 4))], q,
            {"lo": lo, "hi": lo + 10}, scale)
    outs = {}
    for variant in ("int8_reg", "int8", "f32"):
        for chunk in (16, 8):
            step = make_serve_step(
                [CPU], ShardedServeConfig(k=5, ls=24, max_iters=48,
                                          query_chunk=chunk),
                "range", "range", variant=variant)
            a = args if variant != "f32" else (
                args[0], [idx.xb]) + args[2:7]
            outs[variant, chunk] = step(*a)
    (i1, p1, s1), (i2, p2, s2) = outs["int8_reg", 16], outs["int8_reg", 8]
    assert torch.equal(i1, i2)
    assert p1.numpy().tobytes() == p2.numpy().tobytes()
    assert s1.numpy().tobytes() == s2.numpy().tobytes()
    # the int8 variants walk the codes: most ids agree with the f32 walk
    f32_ids = outs["f32", 16][0].numpy()
    for variant in ("int8_reg", "int8"):
        agree = np.mean([len(set(a) & set(b)) / 5 for a, b in
                         zip(outs[variant, 16][0].numpy(), f32_ids)])
        assert agree > 0.6, (variant, agree)
    with pytest.raises(ValueError, match="variant"):
        make_serve_step([CPU], ShardedServeConfig(), "range", "range",
                        variant="bf16")


def test_make_build_step_equals_per_shard_insert():
    rng = np.random.default_rng(4)
    S, n_loc, d = 2, 96, 8
    bcfg = TB.BuildConfig(degree=8, ls_build=16, batch_size=32,
                          cand_pool=32, thresholds=(float("inf"), 0.0),
                          ex_slots=4, ov_max=64)
    xb = torch.from_numpy(rng.normal(size=(S, n_loc, d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (S, n_loc)).astype(
        np.int32))
    xbn = torch.sum(xb * xb, -1)
    graph = torch.full((S, n_loc, bcfg.row_width), -1, dtype=torch.int32)
    degree = torch.zeros((S, n_loc), dtype=torch.int32)
    entries = torch.zeros((S, 1), dtype=torch.int32)
    batch = torch.arange(32, dtype=torch.int32).repeat(S, 1)
    graph[:, 0, 0], degree[:, 0] = 1, 1        # a seed with one edge
    want_g, want_d = [], []
    insert = TB.make_insert_step(bcfg)
    for s in range(S):
        g, dg = insert(graph[s].clone(), degree[s].clone(), xb[s], xbn[s],
                       TF.AttrTable("label", {"label": labels[s]}),
                       batch[s], entries[s])
        want_g.append(g)
        want_d.append(dg)
    step = make_build_step([CPU] * S, bcfg, "label")
    got_g, got_d = step(graph.clone(), degree.clone(), xb, xbn,
                        {"label": labels}, batch, entries)
    assert len(got_g) == S
    for s in range(S):
        assert torch.equal(got_g[s], want_g[s])
        assert torch.equal(got_d[s], want_d[s])
        assert int((got_d[s] > 0).sum()) > 1
