"""The slice as a whole: routed filtered top-k through ``search_auto``.

A ``repro``-built index over the msturing_subset generator (a mixed batch
whose required-bit counts span the prefilter, graph and postfilter bands)
is carried into ``repro_torch`` with ``from_arrays``. In both planning
modes and both layouts, the port's plan must equal the reference's
(selectivity estimates, routes, realized variants) and its results must
match: ids and integer counts exact, keys allclose (another float
summation order). Also: the dispatch pieces, the device contract, and
that the port imports neither jax nor repro.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.beam_search import SearchResult as RResult
from repro.core.jag import JAGConfig, JAGIndex as RIndex
from repro.data import synthetic as RS
from repro.serve import dispatch as RDisp
from repro.serve.planner import PlannerConfig as RPlannerConfig
from repro_torch.core.beam_search import SearchResult as TResult
from repro_torch.core.jag import JAGIndex as TIndex
from repro_torch.data import synthetic as TS
from repro_torch.serve import dispatch as TDisp
from repro_torch.serve.planner import PlannerConfig

torch.set_num_threads(1)

N, D, NQ, K, LS = 2000, 16, 40, 10, 48
REQ = (0, 2, 3, 7)          # sel 1, 1/4, 1/8, 1/128: every route


@pytest.fixture(scope="module")
def pair():
    rds = RS.msturing_subset(n=N, d=D, b=NQ, req_ks=REQ, seed=1)
    tds = TS.msturing_subset(n=N, d=D, b=NQ, req_ks=REQ, seed=1,
                             device="cpu")
    ridx = RIndex.build(rds.xb, rds.attr,
                        JAGConfig(degree=16, ls_build=32, batch_size=128,
                                  cand_pool=64))
    tidx = TIndex.from_arrays(ridx._save_arrays(), device="cpu")
    return rds, tds, ridx, tidx


def _same_result(got, want):
    for f in ("ids", "vlog", "n_expanded", "n_dist"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    np.testing.assert_array_equal(got.primary.numpy(),
                                  np.asarray(want.primary))
    np.testing.assert_allclose(got.secondary.numpy(),
                               np.asarray(want.secondary), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("layout", ["default", "fused"])
@pytest.mark.parametrize("mode", ["per_query", "batch"])
def test_search_auto_matches_reference(pair, mode, layout):
    rds, tds, ridx, tidx = pair
    want, rplan = ridx.search_auto(rds.queries, rds.filt, k=K, ls=LS,
                                   mode=mode, layout=layout,
                                   return_plan=True)
    got, tplan = tidx.search_auto(tds.queries, tds.filt, k=K, ls=LS,
                                  mode=mode, layout=layout, return_plan=True)
    assert np.array_equal(tplan.selectivity, rplan.selectivity)
    assert tplan.route == rplan.route
    assert tplan.realized == rplan.realized
    if mode == "per_query":
        assert tplan.routes == rplan.routes
        assert {g.route for g in tplan.groups} == {"prefilter", "graph",
                                                   "postfilter"}
        for tg, rg in zip(tplan.groups, rplan.groups):
            assert tg.route == rg.route
            assert np.array_equal(tg.ids, rg.ids)
    _same_result(got, want)


def test_forced_routes_match_reference(pair):
    rds, tds, ridx, tidx = pair
    for cfg in (dict(prefilter_max_sel=1.1, postfilter_min_sel=1.2),
                dict(prefilter_max_sel=0.0, postfilter_min_sel=1e-6)):
        want = ridx.search_auto(rds.queries, rds.filt, k=K, ls=LS,
                                planner=RPlannerConfig(**cfg))
        got = tidx.search_auto(tds.queries, tds.filt, k=K, ls=LS,
                               planner=PlannerConfig(**cfg))
        _same_result(got, want)


def test_unfiltered_and_executor_keys(pair):
    rds, tds, ridx, tidx = pair
    want = ridx.search_unfiltered(rds.queries, k=K, ls=LS)
    got = tidx.search_unfiltered(tds.queries, k=K, ls=LS)
    _same_result(got, want)
    tidx.search_auto(tds.queries, tds.filt, k=K, ls=LS)
    routes = {key[0] for key in tidx.executor.cache_keys()}
    assert {"estimate", "prefilter", "graph", "postfilter"} <= routes


def test_dispatch_pieces_match_reference():
    rng = np.random.default_rng(9)

    def parts(B, k, w):
        p = np.sort(rng.integers(0, 2, (B, k)).astype(np.float32), 1)
        s = rng.uniform(0, 5, (B, k)).astype(np.float32)
        ids = rng.integers(-1, 100, (B, k)).astype(np.int32)
        vlog = rng.integers(-1, 100, (B, w)).astype(np.int32)
        ne = rng.integers(0, 9, B).astype(np.int32)
        nd = rng.integers(0, 99, B).astype(np.int32)
        arrs = (ids, p, s, vlog, ne, nd)
        return (RResult(*map(jnp.asarray, arrs)),
                TResult(*map(torch.from_numpy, arrs)))

    (ra, ta), (rb, tb) = parts(6, 5, 4), parts(6, 5, 0)
    _same_result(TDisp.merge_topk(ta, tb, k=5), RDisp.merge_topk(ra, rb, k=5))
    from repro.serve.planner import GroupPlan as RG
    from repro_torch.serve.planner import GroupPlan as TG
    ids_a, ids_b = np.array([0, 2, 3, 5, 7, 8]), np.array([1, 4, 6, 9, 10, 11])
    want = RDisp.regroup([ra, rb], [RG("graph", ids_a, 0.5),
                                    RG("prefilter", ids_b, 0.01)], 12)
    got = TDisp.regroup([ta, tb], [TG("graph", ids_a, 0.5),
                                   TG("prefilter", ids_b, 0.01)], 12)
    _same_result(got, want)
    assert TDisp.route_descriptor("graph", "fused") == \
        RDisp.route_descriptor("graph", "fused")


def test_cuda_is_the_default_and_never_silently_the_cpu(pair):
    _, tds, ridx, _ = pair
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        TIndex.from_arrays(ridx._save_arrays())
    with pytest.raises(RuntimeError, match="cuda"):
        TS.sift_like(n=50, d=4, b=2)


def test_port_imports_neither_jax_nor_repro():
    src = Path(__file__).resolve().parent.parent / "src"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 78, names\n"
        "assert {'repro_torch.core.quantized', 'repro_torch.stream.delta',"
        " 'repro_torch.stream.index', 'repro_torch.train.optimizer',"
        " 'repro_torch.train.steps', 'repro_torch.kernels.autograd',"
        " 'repro_torch.data.pipelines',"
        " 'repro_torch.checkpoint.checkpoint',"
        " 'repro_torch.configs.llama4_scout_17b_a16e',"
        " 'repro_torch.configs.llama4_maverick_400b_a17b',"
        " 'repro_torch.models.recsys', 'repro_torch.models.gnn',"
        " 'repro_torch.data.graph_sampler', 'repro_torch.configs.fm',"
        " 'repro_torch.configs.deepfm', 'repro_torch.configs.wide_deep',"
        " 'repro_torch.configs.din', 'repro_torch.configs.gcn_cora'}"
        " <= set(names),"
        " names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_per_query_dispatch_against_solo_routes(pair):
    """Per-query dispatch against each query run alone through its route.

    Graph and postfilter lanes are bit-identical. Prefilter lanes return
    the same ids and counts; their d2 low-order bits follow the batch on
    the CPU's matmul path (a [B, d] x [d, block] product blocks by B, the
    fault the reference's own per-query test hits), while the kernel path,
    the default on the card, scores each lane on its own: batch-invariant.
    """
    from repro_torch.serve.dispatch import run_route
    _, tds, _, tidx = pair
    q = torch.from_numpy(tds.queries)
    res, p = tidx.search_auto(q, tds.filt, k=K, ls=LS, return_plan=True)
    assert len(p.groups) == 3
    for i in range(NQ):
        solo = run_route(tidx.executor, p.routes[i], q[i:i + 1],
                         tds.filt.take([i]), k=K, ls=LS, max_iters=2 * LS)
        fields = (("ids", "n_dist") if p.routes[i] == "prefilter"
                  else ("ids", "primary", "secondary", "n_dist"))
        for f in fields:
            assert torch.equal(getattr(res, f)[i], getattr(solo, f)[0]), \
                (f, i, p.routes[i])
    pre = torch.as_tensor(p.groups[0].ids)
    batch = tidx.executor.prefilter(q[pre], tds.filt.take(pre), k=K,
                                    use_kernel=True)
    for j, i in enumerate(pre.tolist()):
        solo = tidx.executor.prefilter(q[i:i + 1], tds.filt.take([i]), k=K,
                                       use_kernel=True)
        for f in ("ids", "secondary", "n_dist"):
            assert torch.equal(getattr(batch, f)[j], getattr(solo, f)[0])
