"""The paper's baselines on the port (``repro_torch.core.baselines``) against
the reference's ``repro.core.baselines``.

Inputs come from the same numpy seeds in both packages (the generators draw
the reference's numbers). Held:
- the new generators (``msturing_range``, ``laion_like``, ``make``) and
  ``hard_filter_key_fn`` equal the reference's;
- on the reference's built unfiltered index, carried across with
  ``from_arrays``: post-filter, binary, ACORN and RWalks return the
  reference's ids, n_dist and n_expanded exactly and its keys within
  allclose (rtol 1e-5, atol 1e-3, as the graph route's), and RWalks'
  aggregated table is the reference's bit for bit (range at the reference
  test's size; one subset and one label case smaller);
- the reference's own gates (``tests/test_baselines.py``) on the port's own
  builds: post-filter recall above 0.9 at selectivity 1, JAG above
  post-filter by 0.15 at selectivity under 0.02 with mean recall above
  0.8, ACORN above 0.25, binary above 0.2, RWalks above 0.25, and every
  returned id passing its filter;
- the graph route's recall on the port's ``build_unfiltered`` and
  ``build_binary`` graphs within 0.02 of the reference's on its own; the
  stitched index's recall above 0.9 and within 0.02 of the reference's,
  and its id mapping exact over the reference's sub-indexes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as RBL
from repro.core import distances as RD
from repro.core import filters as RF
from repro.core.ground_truth import exact_filtered_knn as r_exact
from repro.core.jag import JAGConfig as RConfig
from repro.data import synthetic as RS
from repro_torch.core import baselines as BL
from repro_torch.core import distances as TD
from repro_torch.core import filters as TF
from repro_torch.core.ground_truth import exact_filtered_knn
from repro_torch.core.jag import JAGConfig, JAGIndex
from repro_torch.core.recall import recall_at_k
from repro_torch.data import synthetic as TS

torch.set_num_threads(1)

K = 10
RANGE_KW = dict(n=3000, d=16, b=48, seed=1, sel_ks=(1, 100, 1000))
CFG_KW = dict(degree=24, ls_build=48, batch_size=256, cand_pool=96)
SMALL_KW = dict(degree=12, ls_build=24, batch_size=128, cand_pool=48)
ALGOS = ("post_filter", "binary", "acorn", "rwalks")
# keys that hold d2 in the norm form |x|^2 - 2 q.x + |q|^2 round in another
# order than the reference's (a cancellation of terms near |x|^2 + |q|^2,
# hundreds here): test_torch_graph.py's tolerance for the graph route
D2_ATOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))       # a writable copy


def _recall(res, gt_ids):
    return recall_at_k(res.ids.numpy(), res.primary.numpy() == 0.0, gt_ids)


def _small_datasets(kind):
    """(reference, port) datasets of one subset or label case, n = 600."""
    if kind == "subset":
        kw = dict(n=600, d=8, b=16, n_attrs=30, seed=3, req_ks=(2, 4, 6))
        return RS.msturing_subset(**kw), TS.msturing_subset(**kw,
                                                            device="cpu")
    kw = dict(n=600, d=8, b=16, n_labels=6, seed=4)
    return RS.sift_like(**kw), TS.sift_like(**kw, device="cpu")


@pytest.fixture(scope="module")
def carried():
    """Per kind: reference dataset, port dataset, the reference's
    unfiltered index and the same index carried into the port."""
    out = {}
    rds, tds = RS.msturing_range(**RANGE_KW), TS.msturing_range(
        **RANGE_KW, device="cpu")
    out["range"] = (rds, tds, RBL.build_unfiltered(rds.xb, rds.attr,
                                                   RConfig(**CFG_KW)))
    for kind in ("subset", "label"):
        r, t = _small_datasets(kind)
        out[kind] = (r, t, RBL.build_unfiltered(r.xb, r.attr,
                                                RConfig(**SMALL_KW)))
    return {k: (r, t, ri, JAGIndex.from_arrays(ri._save_arrays(),
                                                device="cpu"))
            for k, (r, t, ri) in out.items()}


@pytest.fixture(scope="module")
def own():
    """The port's own builds over the range data: JAG, unfiltered, binary,
    and the exact top-k."""
    ds = TS.msturing_range(**RANGE_KW, device="cpu")
    cfg = JAGConfig(**CFG_KW)
    jag = JAGIndex.build(ds.xb, ds.attr, cfg, device="cpu")
    unf = BL.build_unfiltered(ds.xb, ds.attr, cfg, device="cpu")
    binary = BL.build_binary(ds.xb, ds.attr, cfg, device="cpu")
    gt = exact_filtered_knn(_t(ds.xb), ds.attr, _t(ds.queries), ds.filt,
                            k=K)
    return ds, cfg, jag, unf, binary, gt.ids.numpy()


# ---------------------------------------------------------------------------
# generators and the hard comparator
# ---------------------------------------------------------------------------

def _same_dataset(r, t):
    assert r.name == t.name
    np.testing.assert_array_equal(t.xb, r.xb)
    np.testing.assert_array_equal(t.queries, r.queries)
    np.testing.assert_array_equal(t.selectivity, r.selectivity)
    assert t.attr.kind == r.attr.kind and t.attr.n_bits == r.attr.n_bits
    for k, v in r.attr.data.items():
        np.testing.assert_array_equal(
            t.attr.data[k].numpy(), np.asarray(v).view(np.int32)
            if np.asarray(v).dtype == np.uint32 else np.asarray(v))
    for k, v in r.filt.data.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(
            t.filt.data[k].numpy(),
            v.view(np.int32) if v.dtype == np.uint32 else v)


@pytest.mark.parametrize("name,kw", [
    ("msturing_range", RANGE_KW),
    ("laion_like", dict(n=400, d=8, b=16, correlation="positive", seed=5)),
    ("laion_like", dict(n=400, d=8, b=16, correlation="negative", seed=6)),
    ("laion_like", dict(n=400, d=8, b=16, correlation="random", seed=7)),
    ("sift_like", dict(n=300, d=8, b=16, seed=8)),
])
def test_generators_draw_the_reference_numbers(name, kw):
    assert set(TS.REGISTRY) == set(RS.REGISTRY)
    _same_dataset(RS.make(name, **kw), TS.make(name, device="cpu", **kw))


def _rows_and_filters(m, kind, rng, n, b, **kw):
    if kind == "range":
        return (m.range_table(rng.uniform(0, 1, n).astype(np.float32), **kw),
                m.range_filters(rng.uniform(0, 0.5, b).astype(np.float32),
                                np.full(b, 0.7, np.float32), **kw))
    if kind == "label":
        return (m.label_table(rng.integers(0, 4, n), **kw),
                m.label_filters(rng.integers(0, 4, b), **kw))
    if kind == "subset":
        return (m.subset_table(rng.random((n, 40)) < 0.5, 40, **kw),
                m.subset_filters(rng.random((b, 40)) < 0.1, 40, **kw))
    sat = rng.random((b, 1 << 6)) < 0.3
    return (m.boolean_table(rng.integers(0, 1 << 6, n).astype(np.uint32), 6,
                            **kw),
            m.boolean_filters(sat, 6, **kw))


@pytest.mark.parametrize("kind", ("range", "label", "subset", "boolean"))
@pytest.mark.parametrize("penalty", (1.0, 2.5))
def test_hard_filter_key_fn_matches_reference(kind, penalty):
    n, b, c = 64, 6, 12
    seed = 40 + ("range", "label", "subset", "boolean").index(kind)
    rtab, rfilt = _rows_and_filters(RF, kind, np.random.default_rng(seed),
                                    n, b)
    ttab, tfilt = _rows_and_filters(TF, kind, np.random.default_rng(seed),
                                    n, b, device="cpu")
    rng = np.random.default_rng(seed + 100)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    d2 = rng.uniform(0, 5, (b, c)).astype(np.float32)
    rp, rs = RD.hard_filter_key_fn(rfilt, penalty)(
        jnp.asarray(ids), rtab.gather(jnp.asarray(ids)), jnp.asarray(d2))
    tp, ts = TD.hard_filter_key_fn(tfilt, penalty)(
        _t(ids), ttab.gather(_t(ids)), _t(d2))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    assert 0 < int((tp == 0).sum()) < tp.numel()


# ---------------------------------------------------------------------------
# exact equality on the reference's index, carried across
# ---------------------------------------------------------------------------

def _run(pkg, algo, idx, ds, ls, rw=None):
    if algo == "post_filter":
        return pkg.post_filter_search(idx, ds.queries, ds.filt, k=K, ls=ls)
    if algo == "binary":
        return pkg.binary_search(idx, ds.queries, ds.filt, k=K, ls=ls)
    if algo == "acorn":
        return pkg.acorn_search(idx, ds.queries, ds.filt, k=K, ls=ls)
    return pkg.rwalks_search(rw, ds.queries, ds.filt, k=K, ls=ls)


@pytest.mark.parametrize("kind", ("range", "subset", "label"))
@pytest.mark.parametrize("algo", ALGOS)
def test_baselines_equal_reference_on_carried_index(carried, kind, algo):
    rds, tds, ridx, tidx = carried[kind]
    ls = 48 if kind == "range" else 32
    rrw = trw = None
    if algo == "rwalks":
        rrw = RBL.build_rwalks(rds.xb, rds.attr, None, index=ridx, seed=3)
        trw = BL.build_rwalks(tds.xb, tds.attr, None, index=tidx, seed=3)
    want = _run(RBL, algo, ridx, rds, ls, rrw)
    got = _run(BL, algo, tidx, tds, ls, trw)
    for f in ("ids", "n_dist", "n_expanded"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("primary", "secondary"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=D2_ATOL, err_msg=f)
    assert int((got.ids >= 0).sum()) > 0


@pytest.mark.parametrize("kind", ("range", "subset", "label"))
def test_rwalks_table_is_the_reference_bit_for_bit(carried, kind):
    rds, tds, ridx, tidx = carried[kind]
    want = RBL.build_rwalks(rds.xb, rds.attr, None, m=4, depth=3, seed=9,
                            index=ridx).agg
    got = BL.build_rwalks(tds.xb, tds.attr, None, m=4, depth=3, seed=9,
                          index=tidx).agg
    assert (got.kind, got.n_bits) == (want.kind, want.n_bits)
    assert set(got.data) == set(want.data)
    for k, v in want.data.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(
            got.data[k].numpy(),
            v.view(np.int32) if v.dtype == np.uint32 else v, err_msg=k)


# ---------------------------------------------------------------------------
# the reference's own gates, on the port's own builds
# ---------------------------------------------------------------------------

def test_ground_truth_exact(own):
    ds, _, _, _, _, gt_ids = own
    vals = ds.attr.data["value"].numpy()
    lo, hi = ds.filt.data["lo"].numpy(), ds.filt.data["hi"].numpy()
    d2 = ((ds.queries[:, None] - ds.xb[None]) ** 2).sum(-1)
    mask = (vals[None] >= lo[:, None]) & (vals[None] <= hi[:, None])
    d2m = np.where(mask, d2, np.inf)
    ref = np.argsort(d2m, 1)[:, :K]
    for b in range(len(ref)):
        want = [i for i in ref[b] if d2m[b, i] < np.inf]
        assert list(gt_ids[b][:len(want)]) == want


def test_post_filter_works_high_selectivity(own):
    ds, _, _, unf, _, _ = own
    b = 16
    filt = TF.range_filters(np.zeros(b), np.full(b, 1e6), device="cpu")
    gt = exact_filtered_knn(_t(ds.xb), ds.attr, _t(ds.queries[:b]), filt,
                            k=K)
    res = BL.post_filter_search(unf, ds.queries[:b], filt, k=K, ls=64)
    assert _recall(res, gt.ids.numpy()).mean() > 0.9


def test_jag_beats_post_filter_low_selectivity(own):
    ds, _, jag, unf, _, gt_ids = own
    low = np.asarray(ds.selectivity) < 0.02
    rj = _recall(jag.search(ds.queries, ds.filt, k=K, ls=64), gt_ids)
    rp = _recall(BL.post_filter_search(unf, ds.queries, ds.filt, k=K,
                                       ls=64), gt_ids)
    assert low.sum() >= 5
    assert rj[low].mean() > rp[low].mean() + 0.15, (rj[low].mean(),
                                                    rp[low].mean())
    assert rj.mean() > 0.8


def _assert_valid(ds, res):
    """Every id returned with primary 0 passes its filter."""
    ids = res.ids.numpy()
    ok = (res.primary.numpy() == 0) & (ids >= 0)
    vals = ds.attr.data["value"].numpy()
    lo, hi = ds.filt.data["lo"].numpy(), ds.filt.data["hi"].numpy()
    b, j = np.nonzero(ok)
    assert np.all((lo[b] <= vals[ids[b, j]]) & (vals[ids[b, j]] <= hi[b]))


def test_acorn_binary_and_rwalks_gates(own):
    ds, cfg, _, unf, _, gt_ids = own
    res_a = BL.acorn_search(unf, ds.queries, ds.filt, k=K, ls=48)
    res_b = BL.binary_search(unf, ds.queries, ds.filt, k=K, ls=48)
    rw = BL.build_rwalks(ds.xb, ds.attr, cfg, index=unf)
    res_r = BL.rwalks_search(rw, ds.queries, ds.filt, k=K, ls=48)
    assert _recall(res_a, gt_ids).mean() > 0.25
    assert _recall(res_b, gt_ids).mean() > 0.2
    assert _recall(res_r, gt_ids).mean() > 0.25
    for res in (res_a, res_b, res_r):
        _assert_valid(ds, res)


# ---------------------------------------------------------------------------
# the port's graphs against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ("unfiltered", "binary"))
def test_graph_recall_within_002_of_reference(carried, own, which):
    rds, _, r_unf, _ = carried["range"]
    ds, _, _, unf, binary, gt_ids = own
    ridx = (r_unf if which == "unfiltered"
            else RBL.build_binary(rds.xb, rds.attr, RConfig(**CFG_KW)))
    tidx = unf if which == "unfiltered" else binary
    r = ridx.search(rds.queries, rds.filt, k=K, ls=64)
    rr = recall_at_k(np.asarray(r.ids), np.asarray(r.primary) == 0, gt_ids)
    tr = _recall(tidx.search(ds.queries, ds.filt, k=K, ls=64), gt_ids)
    assert tr.mean() >= rr.mean() - 0.02, (tr.mean(), rr.mean())


STITCH_DS = dict(n=2400, d=16, b=32, n_labels=4, seed=2)
STITCH_CFG = dict(degree=12, ls_build=24, batch_size=128, cand_pool=64)


def test_stitched_label_index_against_reference():
    rds = RS.sift_like(**STITCH_DS)
    tds = TS.sift_like(**STITCH_DS, device="cpu")
    rst = RBL.StitchedLabelIndex(rds.xb, rds.attr, RConfig(**STITCH_CFG))
    tst = BL.StitchedLabelIndex(tds.xb, tds.attr, JAGConfig(**STITCH_CFG),
                                device="cpu")
    gt = r_exact(jnp.asarray(rds.xb), rds.attr, jnp.asarray(rds.queries),
                 rds.filt, k=K)
    gt_ids = np.asarray(gt.ids)
    want = rst.search(rds.queries, rds.filt, k=K, ls=48)
    rr = recall_at_k(np.asarray(want.ids), np.asarray(want.primary) == 0,
                     gt_ids).mean()
    tr = _recall(tst.search(tds.queries, tds.filt, k=K, ls=48),
                 gt_ids).mean()
    assert tr > 0.9 and tr >= rr - 0.02, (tr, rr)
    assert {lab: g.numpy().tolist() for lab, (_, g) in tst.sub.items()} == \
        {lab: np.asarray(g).tolist() for lab, (_, g) in rst.sub.items()}

    # over the reference's sub-indexes, carried across: the same results
    carried = object.__new__(BL.StitchedLabelIndex)
    carried.device = torch.device("cpu")
    carried.sub = {lab: (JAGIndex.from_arrays(idx._save_arrays(),
                                              device="cpu"), _t(g))
                   for lab, (idx, g) in rst.sub.items()}
    got = carried.search(tds.queries, tds.filt, k=K, ls=48)
    for f in ("ids", "primary", "n_dist"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.secondary.numpy(),
                               np.asarray(want.secondary), rtol=1e-5,
                               atol=D2_ATOL)
    assert got.vlog is None and got.n_expanded is None


def unfiltered_graph_recall(n, d=100, degree=16, ls_build=32, cand_pool=64,
                            batch_size=512, reference=True):
    """Unfiltered recall@10 at ls 64 of the pure-vector graph
    (``build_unfiltered``) and of JAG's graph over msturing_subset rows
    (seed 5, 256 queries, every filter passing), in the port and, with
    ``reference``, the reference's pure-vector graph too."""
    kw = dict(degree=degree, ls_build=ls_build, cand_pool=cand_pool,
              batch_size=batch_size, ov_max=2 * batch_size)
    ds = TS.msturing_subset(n=n, d=d, b=256, seed=5, device="cpu")
    allpass = TF.subset_filters(np.zeros((256, 30), bool), 30, device="cpu")
    gt = exact_filtered_knn(_t(ds.xb), ds.attr, _t(ds.queries), allpass,
                            k=K).ids.numpy()
    out = {}
    for name, idx in (
            ("port_unfiltered",
             BL.build_unfiltered(ds.xb, ds.attr, JAGConfig(**kw),
                                 device="cpu")),
            ("port_jag", JAGIndex.build(ds.xb, ds.attr, JAGConfig(**kw),
                                        device="cpu"))):
        out[name] = float(_recall(idx.search_unfiltered(
            ds.queries, k=K, ls=64), gt).mean())
        out[name + "_degree"] = idx.degree_stats()
    if reference:
        rds = RS.msturing_subset(n=n, d=d, b=256, seed=5)
        r = RBL.build_unfiltered(rds.xb, rds.attr, RConfig(**kw))
        res = r.search_unfiltered(rds.queries, k=K, ls=64)
        out["reference_unfiltered"] = float(recall_at_k(
            np.asarray(res.ids), np.asarray(res.primary) == 0, gt).mean())
        out["reference_unfiltered_degree"] = r.degree_stats()
    return out


if __name__ == "__main__":
    # the pure-vector baseline graph on clustered 100-dimensional rows
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--ls-build", type=int, default=32)
    ap.add_argument("--cand-pool", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--threads", type=int, default=1)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    print(json.dumps(unfiltered_graph_recall(
        a.n, degree=a.degree, ls_build=a.ls_build, cand_pool=a.cand_pool,
        batch_size=a.batch_size, reference=not a.port_only)))
