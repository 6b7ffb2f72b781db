"""The streaming index on the port against the reference (``repro.stream``).

One frozen base per filter kind is built with ``repro`` (N0 = 500,
degree 16) and carried into ``repro_torch`` with ``from_arrays``; both
packages then take the same inserts, made from a numpy seed. Held:
- merged results over base + delta with the exact planner: equal to the
  reference's id for id (and to the exact scan over the concatenated
  rows), before and after a compaction;
- the graph route plus the delta before compaction: the reference's ids;
- after compaction: ids stable (delta row j becomes base_n + j) and the
  graph route's recall within 0.02 of the reference's post-compaction
  recall. The build step is batch-variant (``tests/test_torch_build.py``
  explains why), so the two graphs are not compared edge for edge;
- the extended f32 layout equals ``build_layout`` over the concatenation
  bit for bit; int8 after compaction equals a fresh index over the same
  arrays;
- the epoch: an insert bumps it and empties ``cache_keys()``, the
  planner's probe tracks the live table, a frozen index stays at 0;
- archives mid-stream cross both ways: epoch and delta rows bit for bit,
  the same results.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import filters as RF
from repro.core.ground_truth import exact_filtered_knn as r_exact
from repro.core.jag import JAGConfig, JAGIndex as RIndex
from repro.serve.planner import PlannerConfig as RPlannerConfig
from repro.stream import StreamingJAGIndex as RStream
from repro_torch.core import filters as TF
from repro_torch.core.ground_truth import exact_filtered_knn
from repro_torch.core.jag import JAGIndex as TIndex
from repro_torch.core.recall import recall_at_k
from repro_torch.serve.dispatch import fold_topk, merge_topk
from repro_torch.serve.layout import build_layout
from repro_torch.serve.planner import PlannerConfig
from repro_torch.stream import DeltaSegment, StreamingJAGIndex

torch.set_num_threads(1)

N0, D, B, M = 500, 10, 8, 60
CFG = JAGConfig(degree=16, ls_build=32, batch_size=128, cand_pool=64,
                calib_samples=64, n_seeds=8)
FORCE = dict(prefilter_max_sel=1.1, postfilter_min_sel=1.2)  # exact scan
_SEEDS = {"label": 101, "range": 202, "subset": 303, "boolean": 404}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows(m, kind, rng, n, **kw):
    """(vectors, AttrTable) of n fresh rows for one kind, from ``rng``."""
    xv = rng.normal(size=(n, D)).astype(np.float32)
    if kind == "range":
        tab = m.range_table(rng.uniform(0, 1, n).astype(np.float32), **kw)
    elif kind == "label":
        tab = m.label_table(rng.integers(0, 6, n), **kw)
    elif kind == "subset":
        tab = m.subset_table(rng.random((n, 24)) < 0.5, 24, **kw)
    else:
        tab = m.boolean_table(rng.integers(0, 1 << 8, n).astype(np.uint32),
                              8, **kw)
    return xv, tab


def _both_rows(kind, seed, n=M):
    """The same rows for both packages."""
    return (_rows(RF, kind, np.random.default_rng(seed), n),
            _rows(TF, kind, np.random.default_rng(seed), n, device="cpu"))


def _filters(m, kind, sel, **kw):
    if kind == "range":
        return m.range_filters(np.zeros(B, np.float32),
                               np.full(B, sel, np.float32), **kw)
    if kind == "label":
        return m.label_filters(np.full(B, 2), **kw)
    if kind == "subset":
        k = max(0, round(-np.log2(max(sel, 2 ** -9))))
        fb = np.zeros((B, 24), bool)
        fb[:, :k] = True
        return m.subset_filters(fb, 24, **kw)
    rng = np.random.default_rng(7)
    sat = np.zeros((B, 256), bool)
    for i in range(B):
        sat[i, rng.choice(256, max(1, int(sel * 256)), replace=False)] = 1
    return m.boolean_filters(sat, 8, **kw)


def _both_filters(kind, sel):
    return _filters(RF, kind, sel), _filters(TF, kind, sel, device="cpu")


@functools.lru_cache(maxsize=None)
def _base(kind):
    """One reference base and its queries per kind, built once."""
    rng = np.random.default_rng(_SEEDS[kind])
    xb, tab = _rows(RF, kind, rng, N0)
    base = RIndex.build(xb, tab, CFG)
    q = (xb[rng.integers(0, N0, B)]
         + 0.1 * rng.normal(size=(B, D))).astype(np.float32)
    return base, q


def _pair(kind, compact_frac=0.0):
    """Fresh streaming wrappers in both packages over the same base."""
    base, q = _base(kind)
    port = TIndex.from_arrays(base._save_arrays(), device="cpu")
    return (RStream(base, compact_frac=compact_frac),
            StreamingJAGIndex(port, compact_frac=compact_frac), q)


def _insert(r, t, kind, seed, n=M):
    (rx, rtab), (tx, ttab) = _both_rows(kind, seed, n)
    r.insert(rx, rtab, auto_compact=False)
    return t.insert(_t(tx), ttab, auto_compact=False)


def _exact(idx, q, filt):
    """The exact scan over the live concatenated rows (port)."""
    xv, _, _ = idx.delta_arrays()
    xb = torch.cat([idx.base.xb, xv])
    return exact_filtered_knn(xb, idx.attr, _t(q), filt, k=10)


def _same_ids(got, want):
    assert np.array_equal(np.asarray(got.ids), np.asarray(want.ids))


# ---------------------------------------------------------------------------
# delta segment and AttrTable.append
# ---------------------------------------------------------------------------

def test_delta_segment_growth_and_device_cache():
    rng = np.random.default_rng(67)
    tab = TF.range_table(rng.uniform(0, 1, 4).astype(np.float32),
                         device="cpu")
    seg = DeltaSegment.for_table(tab, D)
    assert seg.n == 0 and seg.dev == torch.device("cpu")
    caps = []
    for _ in range(5):
        seg.append(rng.normal(size=(30, D)).astype(np.float32),
                   TF.range_table(rng.uniform(0, 1, 30).astype(np.float32),
                                  device="cpu"))
        caps.append(seg._cap)
    assert seg.n == 150
    assert caps == sorted(caps) and len(set(caps)) < len(caps)   # doubling
    xv, dattr = seg.device()
    assert xv.shape == (150, D) and dattr.n == 150
    assert seg.device()[0] is xv                   # cached until an append
    seg.append(_t(rng.normal(size=(1, D)).astype(np.float32)),
               TF.range_table(np.zeros(1, np.float32), device="cpu"))
    assert seg.device()[0] is not xv               # an append invalidates
    seg.reset()
    assert seg.n == 0 and seg.device()[0].shape == (0, D)


def test_delta_segment_validates_shapes_and_kind():
    tab = TF.range_table(np.zeros(3, np.float32), device="cpu")
    seg = DeltaSegment.for_table(tab, D)
    with pytest.raises(ValueError, match="vectors"):
        seg.append(np.zeros((2, D + 1), np.float32),
                   TF.range_table(np.zeros(2, np.float32), device="cpu"))
    with pytest.raises(ValueError, match="attr rows"):
        seg.append(np.zeros((2, D), np.float32),
                   TF.label_table(np.zeros(2, np.int64), device="cpu"))
    with pytest.raises(ValueError, match="vs"):
        seg.append(np.zeros((2, D), np.float32),
                   TF.range_table(np.zeros(3, np.float32), device="cpu"))


@pytest.mark.parametrize("kind", TF.KINDS)
def test_attr_table_append_matches_reference(kind):
    (_, ra), (_, ta) = _both_rows(kind, 71, 7)
    (_, rb), (_, tb) = _both_rows(kind, 72, 5)
    got, want = ta.append(tb), ra.append(rb)
    assert (got.kind, got.n, got.n_bits) == (want.kind, 12, want.n_bits)
    for k, v in want.data.items():
        v = np.asarray(v)
        assert np.array_equal(got.data[k].numpy().view(v.dtype), v), k


def test_attr_table_append_keeps_bit_weights_and_checks_kind():
    rng = np.random.default_rng(73)
    w = rng.random(24).astype(np.float32)
    a = TF.subset_table(rng.random((6, 24)) < 0.5, 24, bit_weights=w,
                        device="cpu")
    b = TF.subset_table(rng.random((4, 24)) < 0.5, 24, device="cpu")
    ab = a.append(b)
    assert ab.n == 10
    assert np.array_equal(ab.data["bit_weights"].numpy(), w)
    with pytest.raises(ValueError, match="append"):
        a.append(TF.range_table(np.zeros(2, np.float32), device="cpu"))


# ---------------------------------------------------------------------------
# merged search against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", TF.KINDS)
def test_exact_merged_search_matches_reference(kind):
    """Two insert epochs, then a compaction: with every query on the exact
    scan, the merged result is the reference's and the exact scan's over
    the concatenated rows, id for id, and ids survive the compaction."""
    r, t, q = _pair(kind)
    rf, tf = _both_filters(kind, 0.3)
    for seed in (1, 2):
        _insert(r, t, kind, 1000 * seed + _SEEDS[kind])
        want = r.search_auto(q, rf, k=10, ls=64,
                             planner=RPlannerConfig(**FORCE))
        got = t.search_auto(q, tf, k=10, ls=64, planner=PlannerConfig(**FORCE))
        _same_ids(got, want)
        gt = _exact(t, q, tf)
        assert torch.equal(got.ids, gt.ids)
        assert torch.equal(got.secondary, gt.d2)
        np.testing.assert_allclose(got.secondary.numpy(),
                                   np.asarray(want.secondary), rtol=1e-5,
                                   atol=1e-4)
    pre = got                    # the reference's ids, as checked above
    e0, n0 = t.epoch, t.n
    assert t.compact()
    assert t.epoch == e0 + 1 and t.delta.n == 0 and t.n_compactions == 1
    assert int(t.base.xb.shape[0]) == n0
    post = t.search_auto(q, tf, k=10, ls=64, planner=PlannerConfig(**FORCE))
    assert torch.equal(post.ids, pre.ids)
    assert torch.equal(post.ids, _exact(t, q, tf).ids)
    st = t.base.degree_stats()
    assert st["over_budget"] == 0 and st["max"] <= CFG.degree


@pytest.mark.parametrize("kind", ["range", "subset"])
def test_graph_route_plus_delta_matches_reference(kind):
    r, t, q = _pair(kind)
    _insert(r, t, kind, 41)
    rf, tf = _both_filters(kind, 0.4)
    for layout in ("default", "fused"):
        _same_ids(t.search(q, tf, k=10, ls=64, layout=layout),
                  r.search(q, rf, k=10, ls=64, layout=layout))
    want, rp = r.search_auto(q, rf, k=10, ls=64, return_plan=True)
    got, tp = t.search_auto(q, tf, k=10, ls=64, return_plan=True)
    _same_ids(got, want)
    assert tp.realized == rp.realized
    assert all(x.endswith("+delta") for x in tp.realized)
    # the merged search is the graph route and the delta scan, merged
    ex = t.executor
    base = ex.graph(_t(q), tf, k=10, ls=64, max_iters=128)
    extra = ex.delta(_t(q), tf, k=10)
    manual = ex.merge(base, extra, k=10)
    for f in manual._fields:
        assert torch.equal(getattr(t.search(q, tf, k=10, ls=64), f),
                           getattr(manual, f)), f
    assert bool((extra.ids[extra.ids >= 0] >= N0).all())


def test_graph_recall_after_compaction_tracks_reference():
    r, t, q = _pair("subset")
    _insert(r, t, "subset", 61, 120)
    rf, tf = _both_filters("subset", 0.125)
    assert t.compact() and r.compact()
    rb, tb = r.base, t.base
    got = t.search(q, tf, k=10, ls=96)
    want = r.search(q, rf, k=10, ls=96)
    gt = exact_filtered_knn(tb.xb, tb.attr, _t(q), tf, k=10).ids.numpy()
    rgt = np.asarray(r_exact(rb.xb, rb.attr, jnp.asarray(q), rf, k=10).ids)
    assert np.array_equal(gt, rgt)
    rec_t = recall_at_k(got.ids.numpy(), got.primary.numpy() == 0, gt).mean()
    rec_r = recall_at_k(np.asarray(want.ids),
                        np.asarray(want.primary) == 0, gt).mean()
    assert rec_t >= rec_r - 0.02, (rec_t, rec_r)
    # the new rows take part in the graph
    assert int((tb.graph[N0:] >= 0).sum(1).min()) >= CFG.degree // 8


def test_extend_layout_in_compaction_equals_build_layout():
    r, t, q = _pair("boolean")
    t.base.fused_layout("f32")
    _insert(r, t, "boolean", 77, 90)
    assert t.compact()
    b = t.base
    assert torch.equal(b.fused_layout("f32").packed.view(torch.int32),
                       build_layout(b.xb, b.attr).packed.view(torch.int32))


@pytest.mark.parametrize("layout", ["default", "fused"])
def test_int8_after_compaction_equals_fresh_index(layout):
    """The int8 state, warmed before the compaction, is rebuilt over the
    grown rows: the same results as an index made afresh from the same
    arrays."""
    r, t, q = _pair("range")
    _, tf = _both_filters("range", 0.5)
    _insert(r, t, "range", 89)
    t.search_int8(q, tf, k=10, ls=64, layout=layout)
    assert t.compact()
    b = t.base
    fresh = TIndex(b.xb, b.attr, b.graph, b.degree, b.entry, b.cfg,
                   b.build_cfg)
    got = t.search_int8(q, tf, k=10, ls=64, layout=layout)
    want = fresh.search_int8(q, tf, k=10, ls=64, layout=layout)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if layout == "default":
        assert int(b.quantized()[0].shape[0]) == t.n
    else:
        assert b.fused_layout("int8").n == t.n


def test_int8_streaming_search_returns_delta_hits():
    r, t, q = _pair("range")
    _insert(r, t, "range", 43)
    rf, tf = _both_filters("range", 0.9)
    got = t.search_int8(q, tf, k=10, ls=96)
    _same_ids(got, r.search_int8(q, rf, k=10, ls=96))
    assert bool((got.ids[:, 0] >= 0).all())


# ---------------------------------------------------------------------------
# the epoch
# ---------------------------------------------------------------------------

def test_insert_bumps_epoch_and_empties_the_cache():
    r, t, q = _pair("range")
    _, tf = _both_filters("range", 0.4)
    t.search_auto(q, tf, k=5, ls=32)
    ex = t.executor
    assert len(ex.cache_keys()) > 0
    assert all(k[0] == t.epoch for k in ex.cache_keys(full=True))
    e0 = t.epoch
    rep = _insert(r, t, "range", 47)
    assert rep == dict(n_added=M, n_total=N0 + M, epoch=e0 + 1,
                       delta_rows=M, compacted=False)
    assert ex.cache_keys() == ()
    t.search_auto(q, tf, k=5, ls=32)
    assert all(k[0] == t.epoch for k in ex.cache_keys(full=True))
    assert all(key[0] == t.epoch and key[1] == t.n for key in ex._samples)


def test_planner_probe_tracks_live_attr_table():
    """A filter only delta rows match: routed on the live table, it returns
    delta hits (a stale probe would estimate selectivity 0)."""
    _, t, q = _pair("range")
    rng = np.random.default_rng(53)
    filt = TF.range_filters(np.full(B, 2.0, np.float32),
                            np.full(B, 3.0, np.float32), device="cpu")
    res0, p0 = t.search_auto(q, filt, k=10, ls=32, return_plan=True)
    assert float(np.max(p0.selectivity)) == 0.0
    assert bool((res0.ids == -1).all())
    t.insert(rng.normal(size=(M, D)).astype(np.float32),
             TF.range_table(rng.uniform(2.0, 3.0, M).astype(np.float32),
                            device="cpu"), auto_compact=False)
    res1, p1 = t.search_auto(q, filt, k=10, ls=32, return_plan=True)
    assert float(np.min(p1.selectivity)) > 0.0 and p1.n_sampled == t.n
    assert bool((res1.ids[:, 0] >= N0).all())
    assert torch.equal(res1.ids, _exact(t, q, filt).ids)


def test_frozen_index_stays_at_epoch_zero():
    base, q = _base("range")
    idx = TIndex.from_arrays(base._save_arrays(), device="cpu")
    _, tf = _both_filters("range", 0.4)
    assert idx.epoch == 0 and idx.executor.epoch == 0
    idx.search(q, tf, k=5, ls=32)
    keys = idx.executor.cache_keys()
    fn = idx.executor._cache[(0,) + keys[0]]
    idx.search(q, tf, k=5, ls=32)
    assert idx.executor.cache_keys() == keys
    assert idx.executor._cache[(0,) + keys[0]] is fn
    with pytest.raises(TypeError, match="frozen"):
        idx.executor.delta(_t(q), tf, k=5)


def test_auto_compaction_at_the_configured_fraction():
    r, t, q = _pair("label", compact_frac=0.2)
    (_, _), (x1, a1) = _both_rows("label", 59, 50)
    rep1 = t.insert(x1, a1)
    assert not rep1["compacted"] and t.delta.n == 50           # 10% < 20%
    (_, _), (x2, a2) = _both_rows("label", 60, 60)
    rep2 = t.insert(x2, a2)
    assert rep2["compacted"] and t.delta.n == 0                # 22% > 20%
    assert t.n_compactions == 1 and int(t.base.xb.shape[0]) == N0 + 110
    assert rep2["epoch"] == t.epoch == 3      # 2 inserts + 1 compaction


# ---------------------------------------------------------------------------
# merge pieces
# ---------------------------------------------------------------------------

def test_fold_topk_matches_reference():
    from repro.core.beam_search import SearchResult as RResult
    from repro.serve import dispatch as RD
    from repro_torch.core.beam_search import SearchResult as TResult
    rng = np.random.default_rng(5)

    def part(off):
        d2 = np.sort(rng.integers(0, 6, (3, 4)).astype(np.float32), 1)
        ids = (np.arange(4)[None] + off).repeat(3, 0).astype(np.int32)
        ids[0, -1], d2[0, -1] = -1, np.inf
        prim = np.where(ids >= 0, 0.0, np.inf).astype(np.float32)
        cnt = np.full(3, off + 1, np.int32)
        vlog = np.zeros((3, 0), np.int32)
        return ((ids, prim, d2, vlog, cnt, cnt))

    parts = [part(o) for o in (0, 10, 20)]
    got = fold_topk([TResult(*map(_t, p)) for p in parts], k=5)
    want = RD.fold_topk([RResult(*map(jnp.asarray, p)) for p in parts], k=5)
    for f in got._fields:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    two = merge_topk(TResult(*map(_t, parts[0])),
                     TResult(*map(_t, parts[1])), k=5)
    assert torch.equal(fold_topk([TResult(*map(_t, parts[0])),
                                  TResult(*map(_t, parts[1]))], k=5).ids,
                       two.ids)
    with pytest.raises(ValueError):
        fold_topk([], k=5)


# ---------------------------------------------------------------------------
# archives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["subset", "boolean"])
def test_mid_stream_archives_cross_both_ways(kind, tmp_path):
    r, t, q = _pair(kind)
    _insert(r, t, kind, 3000 + _SEEDS[kind])
    rf, tf = _both_filters(kind, 0.4)
    t.save(str(tmp_path / "t.npz"))
    r.save(str(tmp_path / "r.npz"))
    r2 = RStream.load(str(tmp_path / "t.npz"))
    t2 = StreamingJAGIndex.load(str(tmp_path / "r.npz"), device="cpu")
    t3 = StreamingJAGIndex.load(str(tmp_path / "t.npz"), device="cpu")
    for a in (r2, t2, t3):
        assert (a.epoch, a.delta.n, a.n_compactions) == (1, M, 0)
    want_x, want_a = r.delta.rows()
    for a in (r2, t2, t3):
        xv, at = a.delta.rows()
        assert np.array_equal(xv.view(np.uint32), want_x.view(np.uint32))
        for k, v in want_a.items():
            assert np.array_equal(at[k].view(v.dtype), v), k
    want = r.search_auto(q, rf, k=10, ls=64)
    for a, f in ((r2, rf), (t2, tf), (t3, tf)):
        _same_ids(a.search_auto(q, f, k=10, ls=64), want)
    ref_t = t.search_auto(q, tf, k=10, ls=64)
    for f in ref_t._fields:
        assert torch.equal(getattr(t3.search_auto(q, tf, k=10, ls=64), f),
                           getattr(ref_t, f)), f


def test_frozen_archive_loads_as_streaming(tmp_path):
    _, t, _ = _pair("range")
    t.base.save(str(tmp_path / "frozen.npz"))
    s = StreamingJAGIndex.load(str(tmp_path / "frozen.npz"), device="cpu")
    assert s.epoch == 0 and s.delta.n == 0 and s.n == N0


def test_legacy_archive_refuses_compaction_but_serves(tmp_path):
    """An archive without ``build_cfg`` loads with the default build
    parameters (row width 48 against this graph's 32): compaction refuses,
    inserts and merged searches still work."""
    r, t, q = _pair("range")
    full, legacy = str(tmp_path / "full.npz"), str(tmp_path / "legacy.npz")
    t.save(full)
    with np.load(full, allow_pickle=False) as z:
        np.savez_compressed(legacy, **{k: z[k] for k in z.files
                                       if k != "build_cfg"})
    s = StreamingJAGIndex.load(legacy, device="cpu")
    assert s.build_cfg.row_width != int(s.base.graph.shape[1])
    (_, _), (xv, tab) = _both_rows("range", 83)
    s.insert(xv, tab, auto_compact=False)
    _, tf = _both_filters("range", 0.3)
    res = s.search_auto(q, tf, k=10, ls=64, planner=PlannerConfig(**FORCE))
    assert torch.equal(res.ids, _exact(s, q, tf).ids)
    with pytest.raises(ValueError, match="row width"):
        s.compact()


def test_cuda_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device exists")
    base, _ = _base("range")
    path_arrays = base._save_arrays()
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingJAGIndex(TIndex.from_arrays(path_arrays))


def test_build_serves_live():
    """``StreamingJAGIndex.build`` builds the base with the port and serves
    base + delta exactly from the first insert."""
    rng = np.random.default_rng(91)
    xb, tab = _rows(TF, "label", rng, 300, device="cpu")
    s = StreamingJAGIndex.build(xb, tab, CFG, compact_frac=0.5,
                                device="cpu")
    assert s.epoch == 0 and s.n == 300 and s.compact_frac == 0.5
    xv, dtab = _rows(TF, "label", rng, 40, device="cpu")
    s.insert(xv, dtab)
    q = xv[:B] + 0.01
    filt = _filters(TF, "label", 0.2, device="cpu")
    res = s.search_auto(q, filt, k=10, planner=PlannerConfig(**FORCE))
    assert torch.equal(res.ids, _exact(s, q, filt).ids)
