"""The exact masked scan (prefilter route, recall oracle) against the JAX
reference.

``repro_torch.core.ground_truth.exact_filtered_knn`` and
``repro.core.ground_truth.exact_filtered_knn`` on the same numpy inputs:
ids, ``n_dist`` and ``n_feval`` exact; d2 allclose at rtol 1e-5 (another
float summation order). Both the matmul path and the kernel path (whose
plain versions run on the CPU) are covered, on all four kinds and on
compound trees; so are the prefilter route and the recall helpers.
"""
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import filters as RF
from repro.core.ground_truth import exact_filtered_knn as r_knn
from repro.core.recall import evaluate as r_evaluate
from repro.core.recall import recall_at_k as r_recall
from repro_torch.core import filters as TF
from repro_torch.core.ground_truth import exact_filtered_knn as t_knn
from repro_torch.core.recall import evaluate as t_evaluate
from repro_torch.core.recall import recall_at_k as t_recall
from repro_torch.kernels import ref

torch.set_num_threads(1)

N, D, B, L, K = 2500, 12, 10, 10, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    xb = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    labels = rng.integers(0, 5, N)
    values = rng.uniform(0, 100, N).astype(np.float32)
    bits = rng.integers(0, 2, (N, L)).astype(bool)
    assign = rng.integers(0, 2 ** L, N).astype(np.uint32)
    qlab = rng.integers(0, 5, B)
    lo = rng.uniform(0, 80, B).astype(np.float32)
    fbits = (rng.integers(0, 2, (B, L)) * (rng.integers(0, 3, (B, L)) == 0)
             ).astype(bool)
    sat = rng.random((B, 2 ** L)) < 0.05
    sat[:, 0] = True

    def tables(m, **kw):
        return m.joint_table(m.label_table(labels, **kw),
                             m.range_table(values, **kw),
                             m.subset_table(bits, L, **kw),
                             m.boolean_table(assign, L, **kw))

    def filters(m, **kw):
        return {"label": m.label_filters(qlab, **kw),
                "range": m.range_filters(lo, lo + 15.0, **kw),
                "subset": m.subset_filters(fbits, L, **kw),
                "boolean": m.boolean_filters(sat, L, **kw)}

    return (xb, q, tables(RF), tables(TF, device="cpu"), filters(RF),
            filters(TF, device="cpu"))


def _expr(m, f, which):
    lab, rng_, sub, boo = (m.Leaf(f[k]) for k in TF.KINDS)
    if which == "and":
        return rng_ & ~lab & sub
    return (boo | lab) & ~rng_


CASES = list(TF.KINDS) + ["and", "or"]


def _pair(data, case):
    _, _, _, _, rf, tf = data
    if case in TF.KINDS:
        return rf[case], tf[case]
    return _expr(RF, rf, case), _expr(TF, tf, case)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_scan_matches_reference(data, case, use_kernel):
    xb, q, rtab, ttab, _, _ = data
    rfilt, tfilt = _pair(data, case)
    want = r_knn(jnp.asarray(xb), rtab, jnp.asarray(q), rfilt, k=K,
                 block=1024)
    got = t_knn(torch.from_numpy(xb), ttab, torch.from_numpy(q), tfilt, k=K,
                block=1024, use_kernel=use_kernel)
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.n_dist.numpy(), np.asarray(want.n_dist))
    assert np.array_equal(got.n_feval.numpy(), np.asarray(want.n_feval))
    np.testing.assert_allclose(got.d2.numpy(), np.asarray(want.d2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["subset", "boolean", "or"])
def test_kernel_path_equals_plain_impl_exactly(data, case):
    """The scan through ``kernels.ops`` and through ``kernels.ref`` (what
    the chip check compares on the card) agree exactly on the CPU too."""
    xb, q, _, ttab, _, _ = data
    _, tfilt = _pair(data, case)
    a = t_knn(torch.from_numpy(xb), ttab, torch.from_numpy(q), tfilt, k=K,
              block=1000, use_kernel=True)
    b = t_knn(torch.from_numpy(xb), ttab, torch.from_numpy(q), tfilt, k=K,
              block=1000, use_kernel=True, impl=ref)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_scan_handles_fewer_valid_points_than_k(data):
    xb, q, rtab, ttab, _, _ = data
    sat = np.zeros((B, 2 ** L), bool)
    sat[:, 5] = True                         # about N / 1024 valid points
    got = t_knn(torch.from_numpy(xb), ttab, torch.from_numpy(q),
                TF.boolean_filters(sat, L, device="cpu"), k=K)
    want = r_knn(jnp.asarray(xb), rtab, jnp.asarray(q),
                 RF.boolean_filters(sat, L), k=K)
    assert (got.ids.numpy() == -1).any()
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert torch.isinf(got.d2[got.ids < 0]).all()


def test_recall_helpers_agree(data):
    rng = np.random.default_rng(8)
    gt = rng.integers(-1, 50, (B, K))
    res = rng.integers(0, 50, (B, K))
    valid = rng.random((B, K)) < 0.8
    assert np.array_equal(t_recall(res, valid, gt), r_recall(res, valid, gt))



class _Res(NamedTuple):
    ids: object
    primary: object
    n_dist: object


def test_evaluate_agrees_with_reference(data):
    """``evaluate`` of a search whose first three results per query fail
    the filter (primary 1), judged against the exact scan: recall 0.7 per
    query, the mean distance count, and a positive QPS, as the
    reference's ``evaluate`` gives them."""
    xb, q, rtab, ttab, rf, tf = data
    want_gt = r_knn(jnp.asarray(xb), rtab, jnp.asarray(q), rf["range"], k=K)
    got_gt = t_knn(torch.from_numpy(xb), ttab, torch.from_numpy(q),
                   tf["range"], k=K)
    prim = (np.arange(K) < 3).astype(np.float32)[None].repeat(B, 0)
    want = r_evaluate(lambda: _Res(want_gt.ids, jnp.asarray(prim),
                                   want_gt.n_dist), want_gt, timed_repeats=1)
    got = t_evaluate(lambda: _Res(got_gt.ids, torch.from_numpy(prim),
                                  got_gt.n_dist), got_gt, timed_repeats=1)
    assert got.recall == want.recall
    assert got.mean_dist_comps == want.mean_dist_comps
    assert np.array_equal(got.per_query_recall, want.per_query_recall)
    assert got.qps > 0
