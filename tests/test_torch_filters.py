"""repro_torch filters and distances against the JAX reference.

Same numpy inputs through ``repro.core.filters``/``distances`` and their
``repro_torch`` counterparts: validity (``matches``, ``matches_rows`` with
and without the kernel path, ``matches_sampled``), ``dist_F``, ``dist_A``,
the attr-word codec and the bit helpers, on all four kinds and on compound
trees. Every comparison is exact: these are integer or comparison results,
or float values produced by the same single operation.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import distances as RD
from repro.core import filters as RF
from repro_torch.core import distances as TD
from repro_torch.core import filters as TF

torch.set_num_threads(1)

N, B, L = 300, 12, 10
CPU = "cpu"


def _data(seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, N)
    values = rng.uniform(0, 100, N).astype(np.float32)
    bits = rng.integers(0, 2, (N, L)).astype(bool)
    assign = rng.integers(0, 2 ** L, N).astype(np.uint32)
    qlab = rng.integers(0, 6, B)
    lo = rng.uniform(0, 70, B).astype(np.float32)
    fbits = (rng.integers(0, 2, (B, L)) * (rng.integers(0, 3, (B, L)) == 0)
             ).astype(bool)
    sat = rng.integers(0, 2, (B, 2 ** L)).astype(bool)
    sat[:, 0] = True
    return labels, values, bits, assign, qlab, lo, fbits, sat


def _tables(mod, labels, values, bits, assign, **kw):
    return {TF.LABEL: mod.label_table(labels, **kw),
            TF.RANGE: mod.range_table(values, **kw),
            TF.SUBSET: mod.subset_table(bits, L, **kw),
            TF.BOOLEAN: mod.boolean_table(assign, L, **kw)}


def _filters(mod, qlab, lo, fbits, sat, **kw):
    return {TF.LABEL: mod.label_filters(qlab, **kw),
            TF.RANGE: mod.range_filters(lo, lo + 30.0, **kw),
            TF.SUBSET: mod.subset_filters(fbits, L, **kw),
            TF.BOOLEAN: mod.boolean_filters(sat, L, **kw)}


@pytest.fixture(scope="module")
def both():
    labels, values, bits, assign, qlab, lo, fbits, sat = _data()
    rt = _tables(RF, labels, values, bits, assign)
    tt = _tables(TF, labels, values, bits, assign, device=CPU)
    rf = _filters(RF, qlab, lo, fbits, sat)
    tf = _filters(TF, qlab, lo, fbits, sat, device=CPU)
    rj = RF.joint_table(*rt.values())
    tj = TF.joint_table(*tt.values())
    return rt, tt, rf, tf, rj, tj


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _compound(m, f):
    """Three trees over the four leaves, built the same way in both
    packages (``m`` is the filters module)."""
    lab, rng_, sub, boo = (m.Leaf(f[k]) for k in TF.KINDS)
    return [lab & ~rng_, (sub | boo) & lab, ~(rng_ | sub) | (boo & ~lab)]


def test_bit_helpers_match_reference():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (7, 77)).astype(bool)
    rw = np.asarray(RF.pack_bits(bits))
    tw = TF.pack_bits(bits, device=CPU)
    assert np.array_equal(rw.view(np.int32), tw.numpy())
    assert np.array_equal(np.asarray(RF.unpack_bits(rw, 77)),
                          TF.unpack_bits(tw, 77).numpy())
    words = rng.integers(0, 2 ** 32, (9, 5), dtype=np.uint64).astype(
        np.uint32)
    words[0, 0] = 0xFFFFFFFF
    words[0, 1] = 0x80000000
    assert np.array_equal(np.asarray(RF.popcount(jnp.asarray(words))),
                          TF.popcount(torch.from_numpy(
                              words.view(np.int32))).numpy())


@pytest.mark.parametrize("kind", TF.KINDS)
def test_matches_and_dist_f_exact(both, kind):
    rt, tt, rf, tf, _, _ = both
    ids = np.random.default_rng(2).integers(0, N, (B, 40))
    ra = rt[kind].gather(jnp.asarray(ids, jnp.int32))
    ta = tt[kind].gather(torch.as_tensor(ids))
    assert np.array_equal(np.asarray(RF.matches(rf[kind], ra)),
                          TF.matches(tf[kind], ta).numpy())
    assert np.array_equal(np.asarray(RD.dist_f(rf[kind], ra)),
                          TD.dist_f(tf[kind], ta).numpy())


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("tree", range(3))
def test_compound_matches_rows_and_dist_f_exact(both, tree, use_kernel):
    _, _, rf, tf, rj, tj = both
    rexpr = _compound(RF, rf)[tree]
    texpr = _compound(TF, tf)[tree]
    assert rexpr.kind == texpr.kind
    rows = np.arange(0, N, 3)
    rok, rev = RF.matches_rows(rexpr, rj, jnp.asarray(rows, jnp.int32),
                               use_kernel=use_kernel)
    tok, tev = TF.matches_rows(texpr, tj, torch.as_tensor(rows),
                               use_kernel=use_kernel)
    assert np.array_equal(np.asarray(rok), tok.numpy())
    assert np.array_equal(np.asarray(rev), tev.numpy())
    ids = np.random.default_rng(3).integers(0, N, (B, 25))
    ra = rj.gather(jnp.asarray(ids, jnp.int32))
    ta = tj.gather(torch.as_tensor(ids))
    assert np.array_equal(np.asarray(RD.dist_f(rexpr, ra)),
                          TD.dist_f(texpr, ta).numpy())
    assert np.array_equal(
        np.asarray(RF.matches_sampled(rexpr, rj,
                                      jnp.asarray(rows, jnp.int32))),
        TF.matches_sampled(texpr, tj, torch.as_tensor(rows)).numpy())


@pytest.mark.parametrize("kind", TF.KINDS + ("label+range+subset+boolean",))
def test_dist_a_exact(both, kind):
    rt, tt, _, _, rj, tj = both
    rtab = rj if "+" in kind else rt[kind]
    ttab = tj if "+" in kind else tt[kind]
    rng = np.random.default_rng(4)
    ia = rng.integers(0, N, 20)
    ib = rng.integers(0, N, (20, 30))
    want = RD.dist_a(kind, rtab.gather(jnp.asarray(ia, jnp.int32)),
                     rtab.gather(jnp.asarray(ib, jnp.int32)))
    got = TD.dist_a(kind, ttab.gather(torch.as_tensor(ia)),
                    ttab.gather(torch.as_tensor(ib)))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_weighted_subset_dist_a_close():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (N, L)).astype(bool)
    w = rng.uniform(0.1, 3.0, L).astype(np.float32)
    rtab = RF.subset_table(bits, L, bit_weights=w)
    ttab = TF.subset_table(bits, L, bit_weights=w, device=CPU)
    ia, ib = rng.integers(0, N, 10), rng.integers(0, N, (10, 16))
    want = RD.dist_a("subset", rtab.gather(jnp.asarray(ia, jnp.int32)),
                     rtab.gather(jnp.asarray(ib, jnp.int32)))
    got = TD.dist_a("subset", ttab.gather(torch.as_tensor(ia)),
                    ttab.gather(torch.as_tensor(ib)))
    # a float matmul over the weights: summation order may differ
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("kind", TF.KINDS + ("label+range+subset+boolean",))
def test_attr_word_codec_bit_exact(both, kind):
    rt, tt, _, _, rj, tj = both
    rtab = rj if "+" in kind else rt[kind]
    ttab = tj if "+" in kind else tt[kind]
    rw = np.asarray(jax.lax.bitcast_convert_type(RF.pack_attr_words(rtab),
                                                 jnp.uint32))
    tw = TF.pack_attr_words(ttab)
    assert tw.dtype == torch.float32
    assert np.array_equal(rw.view(np.int32), tw.view(torch.int32).numpy())
    # NaN-looking payloads survive a round trip through the codec
    back = TF.unpack_attr_words(ttab.kind, tw, ttab.n_bits)
    for key, val in back.items():
        assert torch.equal(val, ttab.data[key]), key


def test_nan_payload_words_round_trip():
    words = np.array([[0x7FC00001, 0xFFFFFFFF, 0x7F800001]], np.uint32)
    tab = TF.subset_table(words, 96, device=CPU)
    f = TF.pack_attr_words(tab)
    assert torch.isnan(f).all()
    assert np.array_equal(TF.unpack_attr_words("subset", f, 96)["bits"]
                          .numpy().view(np.uint32), words)


def test_expression_surface_matches_reference(both):
    _, _, rf, tf, _, _ = both
    r = RF.as_filter(RF.Leaf(rf["label"]))
    t = TF.as_filter(TF.Leaf(tf["label"]))
    assert isinstance(t, TF.FilterBatch) and r.kind == t.kind
    rexpr = RF.Label(3) & RF.Range(0.5, 2.0) & ~RF.Subset(
        np.eye(1, L, 2, dtype=bool)[0])
    texpr = TF.Label(3, device=CPU) & TF.Range(0.5, 2.0, device=CPU) & ~(
        TF.Subset(np.eye(1, L, 2, dtype=bool)[0], device=CPU))
    assert rexpr.kind == texpr.kind
    assert RF.n_leaves(rexpr) == TF.n_leaves(texpr) == 3
    assert RF.describe(rexpr) == TF.describe(texpr)
    sub = _compound(TF, tf)[1].take(np.array([3, 0, 5]))
    assert sub.batch == 3
    assert torch.equal(sub.leaves()[2].data["label"],
                       tf["label"].data["label"][[3, 0, 5]])


def test_bool_dist_table_matches_reference(both):
    _, _, rf, tf, _, _ = both
    assert np.array_equal(np.asarray(rf["boolean"].data["table"]),
                          tf["boolean"].data["table"].numpy())
