"""int8 serving on the port against the reference (``repro.core.quantized``,
the int8 fused layout and ``search_int8``).

One reference index is built per module with ``repro`` over a joint
range + subset table; its int8 state (``q8__*``) and both fused layouts
ride along in ``_save_arrays()`` into ``repro_torch`` with
``from_arrays``. Tolerances:
- ``quantize_int8`` codes and scales, the int8 layout's packed rows and
  ``fold_query``'s folded query: bitwise (``torch.round`` and
  ``jnp.round`` both round half to even; the dequantized norms sum over d
  in order, which is the reference's order at these widths);
  ``fold_query``'s query norm, a ``torch.sum`` as the traversal's own:
  allclose at rtol 1e-6;
- ``make_int8_dist_fn`` and ``rerank_exact``: allclose at rtol 1e-5, atol
  1e-4 (another summation order of the candidate dots); re-ranked ids
  exact;
- ``search_int8`` in both layouts: ids, ``n_dist``, ``n_expanded`` exact;
  keys allclose;
- within the port, the int8 fused fetch against the split int8 distance:
  allclose at the reference's own rtol 1e-4, atol 1e-3 (``codes . (q *
  scale)`` and ``(codes * scale) . q`` round differently); f32 fused
  stays bitwise equal to default;
- archives and ``save_layout`` files cross both ways bit for bit, and a
  loaded index never re-quantizes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import filters as RF
from repro.core import quantized as RQ
from repro.core.jag import JAGConfig, JAGIndex as RIndex
from repro.serve import layout as RL
from repro.serve.planner import PlannerConfig as RPlannerConfig
from repro_torch.core import filters as TF
from repro_torch.core import quantized as TQ
from repro_torch.core.jag import JAGIndex as TIndex
from repro_torch.serve import layout as TL
from repro_torch.serve.engine import FusedEngine, make_fetch_fn
from repro_torch.serve.planner import PlannerConfig

torch.set_num_threads(1)

N, D, B, L, K, LS = 800, 16, 12, 8, 10, 48
CFG = JAGConfig(degree=16, ls_build=32, batch_size=128, cand_pool=64,
                calib_samples=128)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(10, D)) * 3
    xb = (centers[rng.integers(0, 10, N)]
          + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 10, B)]
         + rng.normal(size=(B, D))).astype(np.float32)
    values = rng.uniform(0, 100, N).astype(np.float32)
    bits = rng.random((N, L)) < 0.5
    lo = rng.uniform(0, 50, B).astype(np.float32)
    fbits = np.zeros((B, L), bool)
    for i in range(B):
        fbits[i, rng.choice(L, 2, replace=False)] = True

    def filters(m, **kw):
        return {"range": m.range_filters(lo, lo + 45.0, **kw),
                "subset": m.subset_filters(fbits, L, **kw)}

    ridx = RIndex.build(xb, RF.joint_table(RF.range_table(values),
                                           RF.subset_table(bits, L)), CFG)
    ridx.quantized()                       # the int8 state rides along
    ridx.fused_layout("int8")
    ridx.fused_layout("f32")
    tidx = TIndex.from_arrays(ridx._save_arrays(), device="cpu")
    return ridx, tidx, xb, q, filters(RF), filters(TF, device="cpu")


def _table(m, kind, rng, n, **kw):
    if kind == "label":
        return m.label_table(rng.integers(0, 5, n), **kw)
    if kind == "range":
        return m.range_table(rng.uniform(0, 1, n).astype(np.float32), **kw)
    if kind == "subset":
        return m.subset_table(rng.random((n, 40)) < 0.5, 40, **kw)
    return m.boolean_table(rng.integers(0, 256, n).astype(np.uint32), 8,
                           **kw)


# ---------------------------------------------------------------------------
# core/quantized.py
# ---------------------------------------------------------------------------

def _ties():
    """Column 0 has max |x| = 127 (scale exactly 1) and .5 quotients that
    round half to even; column 1 is all zeros (scale floored at 1e-12);
    column 2 a negative maximum."""
    x = np.zeros((6, 3), np.float32)
    x[:, 0] = [127.0, 0.5, 1.5, -2.5, -0.5, 126.5]
    x[:, 2] = [-3.0, 1.0, 0.25, -1.5, 2.0, 0.0]
    return x


@pytest.mark.parametrize("case", ["ties", "gaussian", "wide"])
def test_quantize_int8_bitwise(case):
    rng = np.random.default_rng(1)
    x = {"ties": _ties(),
         "gaussian": rng.normal(size=(300, 24)).astype(np.float32),
         "wide": (rng.normal(size=(200, 16)) * 10.0 ** rng.integers(
             -3, 4, 16)).astype(np.float32)}[case]
    rc, rs = RQ.quantize_int8(x)
    tc, ts = TQ.quantize_int8(_t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tc.numpy(), np.asarray(rc))
    assert np.array_equal(ts.numpy().view(np.uint32),
                          np.asarray(rs).view(np.uint32))
    if case == "ties":
        assert tc[:, 0].tolist() == [127, 0, 2, -2, 0, 126]
        assert not bool(tc[:, 1].any()) and float(ts[1]) == np.float32(1e-12)


def test_int8_dist_fn_and_rerank_match_reference():
    rng = np.random.default_rng(2)
    n, d, b, c = 300, D, 4, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    qn = (q * q).sum(-1)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    rc, rs = RQ.quantize_int8(x)
    rnorm = jnp.sum((rc.astype(jnp.float32) * rs) ** 2, -1)
    tc, ts = TQ.quantize_int8(_t(x))
    tnorm = TQ.dequant_sq_norms(tc, ts)
    assert np.array_equal(tnorm.numpy(), np.asarray(rnorm))
    want = RQ.make_int8_dist_fn(rs)(rc, rnorm, jnp.asarray(ids),
                                    jnp.asarray(q), jnp.asarray(qn))
    got = TQ.make_int8_dist_fn(ts)(tc, tnorm, _t(ids), _t(q), _t(qn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    # rerank: -1 holes and primary ties that the exact d2 must order
    rids = ids.copy()
    rids[:, -3:] = -1
    prim = rng.integers(0, 2, (b, c)).astype(np.float32)
    xn = (x * x).sum(-1)
    want = RQ.rerank_exact(jnp.asarray(x), jnp.asarray(xn),
                           jnp.asarray(rids), jnp.asarray(prim),
                           jnp.asarray(q), K)
    got = TQ.rerank_exact(_t(x), _t(xn), _t(rids), _t(prim), _t(q), K)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_fuse_rows_matches_reference():
    rng = np.random.default_rng(3)
    codes = rng.integers(-127, 128, (20, 6)).astype(np.int8)
    norm = rng.random(20).astype(np.float32)
    val = rng.random(20).astype(np.float32)
    assert np.array_equal(TQ.fuse_rows(_t(codes), _t(norm), _t(val)).numpy(),
                          np.asarray(RQ.fuse_rows(codes, norm, val)))


# ---------------------------------------------------------------------------
# serve/layout.py and serve/engine.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", TF.KINDS)
def test_int8_layout_and_fold_query_bitwise(kind):
    rng = np.random.default_rng(4)
    n = 200
    x = rng.normal(size=(n, D)).astype(np.float32)
    rt = _table(RF, kind, np.random.default_rng(5), n)
    tt = _table(TF, kind, np.random.default_rng(5), n, device="cpu")
    rl = RL.build_layout(x, rt, vec_dtype="int8")
    tl = TL.build_layout(_t(x), tt, vec_dtype="int8")
    assert (tl.vec_dtype, tl.d, tl.kind, tl.n_bits) == (
        rl.vec_dtype, rl.d, rl.kind, rl.n_bits)
    assert np.array_equal(tl.packed.numpy().view(np.uint32),
                          np.asarray(rl.packed).view(np.uint32))
    assert np.array_equal(tl.q_scale.numpy(), np.asarray(rl.q_scale))
    q = rng.normal(size=(5, D)).astype(np.float32)
    (q_eff, q_norm), (r_eff, r_norm) = tl.fold_query(_t(q)), rl.fold_query(q)
    assert np.array_equal(q_eff.numpy(), np.asarray(r_eff))
    # the query norm is a torch.sum, as greedy_search's: another order
    np.testing.assert_allclose(q_norm.numpy(), np.asarray(r_norm),
                               rtol=1e-6)


def test_int8_fused_fetch_against_split_distance():
    """Within the port: the fused int8 fetch folds the scale into the
    query, the split route dequantizes the rows; allclose at the
    reference's own tolerance, attrs exact."""
    rng = np.random.default_rng(6)
    n, d, b, c = 300, 32, 4, 12
    x = rng.normal(size=(n, d)).astype(np.float32)
    tab = _table(TF, "range", rng, n, device="cpu")
    lay = TL.build_layout(_t(x), tab, vec_dtype="int8")
    q = _t(rng.normal(size=(b, d)).astype(np.float32))
    qn = (q * q).sum(-1)
    ids = _t(rng.integers(0, n, (b, c)).astype(np.int32))
    d2, attrs = make_fetch_fn(lay)(ids, q, qn)
    codes, scale = TQ.quantize_int8(_t(x))
    want = TQ.make_int8_dist_fn(scale)(codes, TQ.dequant_sq_norms(
        codes, scale), ids, q, qn)
    np.testing.assert_allclose(d2.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-3)
    assert torch.equal(attrs["value"], tab.gather(ids)["value"])


def test_fused_engine_contract():
    rng = np.random.default_rng(7)
    for dt in TL.VEC_DTYPES:
        lay = TL.build_layout(_t(rng.normal(size=(64, 8)).astype(
            np.float32)), _table(TF, "label", rng, 64, device="cpu"),
            vec_dtype=dt)
        eng = FusedEngine(lay)
        assert eng.gathers_per_expansion == 1
        assert eng.row_bytes == (8 + 1 + 1) * 4
        d2, attrs = eng.fetch_fn(torch.zeros((2, 4), dtype=torch.int32),
                                 torch.zeros((2, 8)), torch.zeros((2,)))
        assert d2.shape == (2, 4) and attrs["label"].shape == (2, 4)


@pytest.mark.parametrize("vec_dtype", ["f32", "int8"])
def test_save_load_layout_cross_both_ways(tmp_path, vec_dtype):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(50, D)).astype(np.float32)
    w = rng.random(40).astype(np.float32)
    bits = rng.random((50, 40)) < 0.5
    rl = RL.build_layout(x, RF.subset_table(bits, 40, bit_weights=w),
                         vec_dtype=vec_dtype)
    tl = TL.build_layout(_t(x), TF.subset_table(bits, 40, bit_weights=w,
                                                device="cpu"),
                         vec_dtype=vec_dtype)
    TL.save_layout(str(tmp_path / "t.npz"), tl)
    RL.save_layout(str(tmp_path / "r.npz"), rl)
    from_t = RL.load_layout(str(tmp_path / "t.npz"))
    from_r = TL.load_layout(str(tmp_path / "r.npz"), device="cpu")
    for got, want in ((from_t.packed, tl.packed), (from_r.packed,
                                                   rl.packed)):
        assert np.array_equal(np.asarray(got).view(np.uint32),
                              np.asarray(want).view(np.uint32))
    for lay in (from_t, from_r):
        assert (lay.kind, lay.n_bits, lay.d, lay.vec_dtype) == (
            "subset", 40, D, vec_dtype)
        assert np.array_equal(np.asarray(lay.bit_weights), w)
        assert np.array_equal(np.asarray(lay.q_scale),
                              np.asarray(rl.q_scale))


def test_extend_layout_equals_build_and_refuses_int8():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(70, D)).astype(np.float32)
    tab = _table(TF, "subset", rng, 70, device="cpu")
    head = TF.AttrTable("subset", {"bits": tab.data["bits"][:50]}, 40)
    tail = TF.AttrTable("subset", {"bits": tab.data["bits"][50:]}, 40)
    ext = TL.extend_layout(TL.build_layout(_t(x[:50]), head), _t(x[50:]),
                           tail)
    full = TL.build_layout(_t(x), tab)
    assert torch.equal(ext.packed.view(torch.int32),
                       full.packed.view(torch.int32))
    with pytest.raises(ValueError, match="int8"):
        TL.extend_layout(TL.build_layout(_t(x[:50]), head,
                                         vec_dtype="int8"), _t(x[50:]), tail)
    with pytest.raises(ValueError, match="attr rows"):
        TL.extend_layout(full, _t(x[:2]),
                         TF.range_table(np.zeros(2, np.float32),
                                        device="cpu"))


# ---------------------------------------------------------------------------
# search_int8 and search_auto(dtype="int8") on a carried index
# ---------------------------------------------------------------------------

def test_from_arrays_carries_the_int8_state(setup):
    ridx, tidx, *_ = setup
    for got, want in zip(tidx.quantized(), ridx.quantized()):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(
        tidx.fused_layout("int8").packed.numpy().view(np.uint32),
        np.asarray(ridx.fused_layout("int8").packed).view(np.uint32))
    assert tidx.fused_layout("int8").vec_dtype == "int8"


@pytest.mark.parametrize("layout", ["default", "fused"])
@pytest.mark.parametrize("kind", ["range", "subset"])
def test_search_int8_matches_reference(setup, kind, layout):
    ridx, tidx, _, q, rf, tf = setup
    want = ridx.search_int8(q, rf[kind], k=K, ls=LS, layout=layout)
    got = tidx.search_int8(q, tf[kind], k=K, ls=LS, layout=layout)
    for f in ("ids", "n_dist", "n_expanded", "vlog"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    np.testing.assert_allclose(got.primary.numpy(), np.asarray(want.primary),
                               rtol=1e-5)
    np.testing.assert_allclose(got.secondary.numpy(),
                               np.asarray(want.secondary), rtol=1e-5,
                               atol=1e-3)
    assert ("graph", layout, "int8", K, LS, 2 * LS, kind) in \
        tidx.executor.cache_keys()


@pytest.mark.parametrize("mode", ["per_query", "batch"])
def test_search_auto_int8_realizes_fused_int8(setup, mode):
    ridx, tidx, _, q, rf, tf = setup
    forced = dict(prefilter_max_sel=0.0, postfilter_min_sel=1.1)
    want, rp = ridx.search_auto(q, rf["range"], k=K, ls=LS, layout="fused",
                                dtype="int8", mode=mode, return_plan=True,
                                planner=RPlannerConfig(**forced))
    got, tp = tidx.search_auto(q, tf["range"], k=K, ls=LS, layout="fused",
                               dtype="int8", mode=mode, return_plan=True,
                               planner=PlannerConfig(**forced))
    realized = (tp.realized,) if mode == "batch" else tp.realized
    assert set(realized) == {"graph[fused,int8]"}
    assert tp.realized == rp.realized
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))


def test_f32_fused_stays_bitwise_equal_to_default(setup):
    """The int8 state on the same index leaves the f32 contract alone."""
    ridx, _, _, q, _, tf = setup
    arrays = {k: v for k, v in ridx._save_arrays().items()
              if not k.startswith("fused_f32")}
    tidx = TIndex.from_arrays(arrays, device="cpu")
    tidx.search_int8(q, tf["subset"], k=K, ls=LS, layout="fused")
    for kind in ("range", "subset"):
        a = tidx.search(q, tf[kind], k=K, ls=LS)
        b = tidx.search(q, tf[kind], k=K, ls=LS, layout="fused")
        for x, y in zip(a, b):
            assert np.array_equal(x.numpy().view(np.uint8),
                                  y.numpy().view(np.uint8))


def test_quantized_is_cached_and_layout_lanes_agree(setup):
    _, _, xb, _, _, _ = setup
    tab = TF.range_table(np.zeros(N, np.float32), device="cpu")
    idx = TIndex(_t(xb), tab, torch.zeros((N, 1), dtype=torch.int32),
                 torch.zeros(N, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), CFG, None)
    codes, scale, norms = idx.quantized()
    assert idx.quantized()[0] is codes
    lay = idx.fused_layout("int8")
    assert torch.equal(lay.packed[:, :D], codes.to(torch.float32))
    assert torch.equal(lay.packed[:, D], norms)
    assert torch.equal(lay.q_scale, scale)


# ---------------------------------------------------------------------------
# archives with q8__* and fused_int8__* keys, both ways
# ---------------------------------------------------------------------------

def test_archives_cross_both_ways_without_requantizing(setup, tmp_path):
    ridx, tidx, _, q, rf, tf = setup
    # the reference's archive into the port, with a marked code: a
    # re-quantization would undo it
    arrs = ridx._save_arrays()
    codes = np.array(arrs["q8__codes"])
    codes[0, 0] = np.int8(-codes[0, 0] or 1)
    arrs["q8__codes"] = codes
    path_r = str(tmp_path / "ref.npz")
    np.savez_compressed(path_r, **arrs)
    loaded = TIndex.load(path_r, device="cpu")
    assert np.array_equal(loaded.quantized()[0].numpy(), codes)
    # the port's archive into the reference
    path_t = str(tmp_path / "port.npz")
    tidx.save(path_t)
    with np.load(path_t, allow_pickle=False) as z:
        for k in ("q8__codes", "q8__scale", "q8__norms",
                  "fused_int8__packed_bits", "fused_int8__q_scale",
                  "fused_int8__bit_weights"):
            assert k in z.files, k
        assert z["q8__codes"].dtype == np.int8
        assert z["fused_int8__packed_bits"].dtype == np.uint32
    back = RIndex.load(path_t)
    for got, want in zip(back.quantized(), ridx.quantized()):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(
        np.asarray(back.fused_layout("int8").packed).view(np.uint32),
        np.asarray(ridx.fused_layout("int8").packed).view(np.uint32))
    for layout in ("default", "fused"):
        a = back.search_int8(q, rf["range"], k=K, ls=LS, layout=layout)
        b = TIndex.load(path_t, device="cpu").search_int8(
            q, tf["range"], k=K, ls=LS, layout=layout)
        assert np.array_equal(np.asarray(a.ids), b.ids.numpy())


def test_executor_refuses_unknown_dtype_and_layout(setup):
    _, tidx, _, q, _, tf = setup
    with pytest.raises(ValueError, match="dtype"):
        tidx.executor.graph(_t(q), tf["range"], k=K, ls=LS,
                            max_iters=2 * LS, dtype="bf16")
    with pytest.raises(ValueError, match="vec_dtype"):
        TL.build_layout(_t(q), TF.range_table(np.zeros(B, np.float32),
                                              device="cpu"),
                        vec_dtype="int4")
