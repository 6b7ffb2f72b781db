"""The graph route on a JAX-built index carried across with ``from_arrays``.

One reference index is built per module with ``repro`` over a joint table
of all four attribute kinds; ``repro_torch.JAGIndex.from_arrays`` takes its
``_save_arrays()`` dict. The port's graph route must return the reference
``Executor.graph``'s ids, ``n_expanded`` and ``n_dist`` for every kind and
for compound trees (keys allclose: another float summation order), and
the fused f32 layout must equal the default layout bit for bit inside
torch. Also: both ``dedup`` modes of ``greedy_search``, the stable
two-key beam sort, and whether a ``-0.0`` key can arise.
"""
from dataclasses import asdict

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import filters as RF
from repro.core.beam_search import greedy_search as r_greedy
from repro.core.distances import query_key_fn as r_key
from repro.core.jag import JAGConfig, JAGIndex as RIndex
from repro_torch.core import filters as TF
from repro_torch.core.beam_search import greedy_search as t_greedy
from repro_torch.core.distances import lex_sort
from repro_torch.core.distances import query_key_fn as t_key
from repro_torch.core.jag import JAGIndex as TIndex

torch.set_num_threads(1)

N, D, B, L, K, LS = 1500, 16, 16, 8, 10, 48
CFG = JAGConfig(degree=16, ls_build=32, batch_size=128, cand_pool=64)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(12, D)) * 3
    xb = (centers[rng.integers(0, 12, N)]
          + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 12, B)]
         + rng.normal(size=(B, D))).astype(np.float32)
    labels = rng.integers(0, 4, N)
    values = rng.uniform(0, 100, N).astype(np.float32)
    bits = rng.random((N, L)) < 0.5
    assign = rng.integers(0, 2 ** L, N).astype(np.uint32)
    qlab = rng.integers(0, 4, B)
    lo = rng.uniform(0, 60, B).astype(np.float32)
    fbits = np.zeros((B, L), bool)
    for i in range(B):
        fbits[i, rng.choice(L, 2, replace=False)] = True
    sat = rng.random((B, 2 ** L)) < 0.3
    sat[:, 0] = True

    def tables(m, **kw):
        return m.joint_table(m.label_table(labels, **kw),
                             m.range_table(values, **kw),
                             m.subset_table(bits, L, **kw),
                             m.boolean_table(assign, L, **kw))

    def filters(m, **kw):
        return {"label": m.label_filters(qlab, **kw),
                "range": m.range_filters(lo, lo + 40.0, **kw),
                "subset": m.subset_filters(fbits, L, **kw),
                "boolean": m.boolean_filters(sat, L, **kw)}

    ridx = RIndex.build(xb, tables(RF), CFG)
    ridx.fused_layout("f32")               # rides along in the archive
    tidx = TIndex.from_arrays(ridx._save_arrays(), device="cpu")
    return ridx, tidx, q, filters(RF), filters(TF, device="cpu")


def _pair(setup, case):
    _, _, _, rf, tf = setup
    if case in TF.KINDS:
        return rf[case], tf[case]
    m_r, m_t = RF, TF
    if case == "and":
        return (m_r.Leaf(rf["range"]) & ~m_r.Leaf(rf["label"]),
                m_t.Leaf(tf["range"]) & ~m_t.Leaf(tf["label"]))
    return (m_r.Leaf(rf["subset"]) | m_r.Leaf(rf["boolean"]),
            m_t.Leaf(tf["subset"]) | m_t.Leaf(tf["boolean"]))


def test_from_arrays_carries_the_index(setup):
    ridx, tidx, _, _, _ = setup
    assert asdict(tidx.cfg) == asdict(ridx.cfg)
    assert asdict(tidx.build_cfg) == asdict(ridx.build_cfg)
    assert np.array_equal(tidx.graph.numpy(), np.asarray(ridx.graph))
    assert np.array_equal(tidx.entry.numpy(), np.asarray(ridx.entry))
    assert tidx.attr.kind == ridx.attr.kind
    for k, v in ridx.attr.data.items():
        assert np.array_equal(tidx.attr.data[k].numpy().view(
            np.asarray(v).dtype), np.asarray(v)), k
    packed = np.asarray(ridx.fused_layout("f32").packed)
    assert np.array_equal(tidx.fused_layout("f32").packed.numpy().view(
        np.uint32), packed.view(np.uint32))


@pytest.mark.parametrize("layout", ["default", "fused"])
@pytest.mark.parametrize("case", list(TF.KINDS) + ["and", "or"])
def test_graph_route_matches_reference(setup, case, layout):
    ridx, tidx, q, _, _ = setup
    rfilt, tfilt = _pair(setup, case)
    want = ridx.executor.graph(jnp.asarray(q), rfilt, k=K, ls=LS,
                               max_iters=2 * LS, layout=layout)
    got = tidx.executor.graph(torch.from_numpy(q), tfilt, k=K, ls=LS,
                              max_iters=2 * LS, layout=layout)
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.n_expanded.numpy(),
                          np.asarray(want.n_expanded))
    assert np.array_equal(got.n_dist.numpy(), np.asarray(want.n_dist))
    assert np.array_equal(got.vlog.numpy(), np.asarray(want.vlog))
    np.testing.assert_allclose(got.primary.numpy(), np.asarray(want.primary),
                               rtol=1e-5)
    np.testing.assert_allclose(got.secondary.numpy(),
                               np.asarray(want.secondary), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("case", list(TF.KINDS) + ["and", "or"])
def test_fused_f32_bitwise_equal_to_default(setup, case):
    # the layout is packed by torch here: the carried-over one holds the
    # reference's norms, computed in another summation order
    ridx, _, q, _, _ = setup
    arrays = {k: v for k, v in ridx._save_arrays().items()
              if not k.startswith("fused_")}
    tidx = TIndex.from_arrays(arrays, device="cpu")
    _, tfilt = _pair(setup, case)
    a = tidx.search(q, tfilt, k=K, ls=LS)
    b = tidx.search(q, tfilt, k=K, ls=LS, layout="fused")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert np.array_equal(x.numpy().view(np.uint8),
                              y.numpy().view(np.uint8))


def test_dedup_scan_mode_matches_reference(setup):
    ridx, tidx, q, rf, tf = setup
    want = r_greedy(ridx.graph, ridx.xb, ridx.xb_norm, ridx.attr,
                    jnp.asarray(q), ridx.entry, r_key(rf["label"]), ls=LS,
                    k=K, max_iters=2 * LS, dedup="scan")
    got = t_greedy(tidx.graph, tidx.xb, tidx.xb_norm, tidx.attr,
                   torch.from_numpy(q), tidx.entry, t_key(tf["label"]),
                   ls=LS, k=K, max_iters=2 * LS, dedup="scan")
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.n_dist.numpy(), np.asarray(want.n_dist))
    assert np.array_equal(got.n_expanded.numpy(),
                          np.asarray(want.n_expanded))


def test_lex_sort_is_jax_two_key_stable_sort():
    import jax
    rng = np.random.default_rng(12)
    p = rng.integers(0, 3, (5, 40)).astype(np.float32)
    s = rng.integers(0, 4, (5, 40)).astype(np.float32)
    p[:, -6:] = np.inf                          # INF/-1 padding slots
    s[:, -6:] = np.inf
    ids = np.tile(np.arange(40, dtype=np.int32), (5, 1))
    ids[:, -6:] = -1
    rp, rs, ri = jax.lax.sort((jnp.asarray(p), jnp.asarray(s),
                               jnp.asarray(ids)), num_keys=2)
    tp, ts, ti = lex_sort(torch.from_numpy(p), torch.from_numpy(s),
                          torch.from_numpy(ids))
    assert np.array_equal(ti.numpy(), np.asarray(ri))
    assert np.array_equal(tp.numpy(), np.asarray(rp))
    assert np.array_equal(ts.numpy(), np.asarray(rs))


def test_no_negative_zero_key_arises(setup):
    """XLA's sort orders -0.0 before +0.0, torch.sort treats them as equal:
    the beam keys must never hold a -0.0. Queries equal to database points
    and the zero vector (d2 exactly 0) and every kind's dist_F (0 on a
    match) are the cases where one could appear."""
    _, tidx, q, _, tf = setup
    probes = torch.cat([tidx.xb[:8], torch.zeros((8, D)),
                        -tidx.xb[8:16], torch.from_numpy(q)])[:B]
    for case in list(TF.KINDS) + ["and", "or"]:
        _, tfilt = _pair(setup, case)
        for layout in ("default", "fused"):
            res = tidx.search(probes, tfilt, k=LS, ls=LS, layout=layout)
            for key in (res.primary, res.secondary):
                zero = key == 0
                assert not bool(torch.signbit(key[zero]).any()), case
    res = tidx.search_unfiltered(probes, k=LS, ls=LS)
    assert not bool(torch.signbit(res.secondary[res.secondary == 0]).any())
    assert int((res.secondary == 0).sum()) >= 4  # exact matches were found
