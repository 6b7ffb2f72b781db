"""The port's index build (core/build.py, core/prune.py) against the JAX
reference.

Whole builds are compared by what they must share, not by adjacency bytes
(the reference's candidate dots are batch-variant einsums): calibrated
thresholds, seeds, the degree bound, and graph-route recall within 0.02 of
a ``repro``-built index on the same data and seeds. The integer pieces of
an insert step (pool dedup, reverse-edge scatter, overflow selection) and
the prune on identical float inputs are compared exactly. Archives written
by the port load in the reference, and back.

Run as a script, ``python tests/test_torch_build.py --n 20000 [--degree R
--ls-build L --cand-pool C --batch-size B]`` holds the two builds against
each other at a chosen size and MSTuring's width (``compare_builds``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import build as RB
from repro.core import prune as RP
from repro.core.jag import JAGConfig as RConfig, JAGIndex as RIndex
from repro.core.recall import recall_at_k
from repro.data import synthetic as RS
from repro_torch.core import build as TB
from repro_torch.core import prune as TP
from repro_torch.core.jag import JAGConfig, JAGIndex
from repro_torch.data import synthetic as TS

torch.set_num_threads(1)

N, D, NQ, K, LS = 1500, 16, 48, 10, 64
KW = dict(degree=16, ls_build=32, batch_size=128, cand_pool=64)


@pytest.fixture(scope="module")
def built():
    rds = RS.msturing_subset(n=N, d=D, b=NQ, n_attrs=12,
                             req_ks=(1, 2, 3), seed=3)
    tds = TS.msturing_subset(n=N, d=D, b=NQ, n_attrs=12,
                             req_ks=(1, 2, 3), seed=3, device="cpu")
    ridx = RIndex.build(rds.xb, rds.attr, RConfig(**KW))
    tidx = JAGIndex.build(tds.xb, tds.attr, JAGConfig(**KW), device="cpu")
    return rds, tds, ridx, tidx


def test_generators_draw_the_reference_numbers(built):
    rds, tds, _, _ = built
    assert np.array_equal(rds.xb, tds.xb)
    assert np.array_equal(rds.queries, tds.queries)
    assert np.array_equal(rds.selectivity, tds.selectivity)
    assert np.array_equal(np.asarray(rds.attr.data["bits"]).view(np.int32),
                          tds.attr.data["bits"].numpy())
    assert np.array_equal(np.asarray(rds.filt.data["bits"]).view(np.int32),
                          tds.filt.data["bits"].numpy())


def test_build_calibration_seeds_and_degree(built):
    _, _, ridx, tidx = built
    assert tidx.build_cfg.thresholds == ridx.build_cfg.thresholds
    assert np.array_equal(tidx.entry.numpy(), np.asarray(ridx.entry))
    deg = torch.sum(tidx.graph >= 0, dim=1)
    assert int(deg.max()) <= KW["degree"]
    assert torch.equal(deg.to(torch.int32), tidx.degree)
    assert int(deg.min()) >= 1
    g = tidx.graph
    assert bool(((g == -1) | ((g >= 0) & (g < N))).all())
    self_loop = g == torch.arange(N)[:, None]
    assert not bool(self_loop.any())


def test_graph_recall_within_002_of_reference(built):
    rds, tds, ridx, tidx = built
    gt = ridx.executor.prefilter(jnp.asarray(rds.queries), rds.filt, k=K)
    gt_ids = np.asarray(gt.ids)
    r = ridx.search(rds.queries, rds.filt, k=K, ls=LS)
    t = tidx.search(tds.queries, tds.filt, k=K, ls=LS)
    rr = recall_at_k(np.asarray(r.ids), np.asarray(r.primary) == 0, gt_ids)
    tr = recall_at_k(t.ids.numpy(), t.primary.numpy() == 0, gt_ids)
    assert tr.mean() >= rr.mean() - 0.02, (tr.mean(), rr.mean())


def test_archives_cross_between_packages(built, tmp_path):
    rds, tds, ridx, tidx = built
    tidx.fused_layout("f32")
    tidx.save(str(tmp_path / "port.npz"))
    back = JAGIndex.load(str(tmp_path / "port.npz"), device="cpu")
    assert torch.equal(back.graph, tidx.graph)
    a = tidx.search(tds.queries, tds.filt, k=K, ls=LS, layout="fused")
    b = back.search(tds.queries, tds.filt, k=K, ls=LS, layout="fused")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.secondary,
                                                     b.secondary)
    # the reference reads the port's archive and serves the same graph
    ref = RIndex.load(str(tmp_path / "port.npz"))
    assert np.array_equal(np.asarray(ref.graph), tidx.graph.numpy())
    rres = ref.search(rds.queries, rds.filt, k=K, ls=LS)
    assert np.array_equal(np.asarray(rres.ids), a.ids.numpy())


def test_insert_step_integer_pieces_match_reference():
    rng = np.random.default_rng(5)
    n, R, EX, Bb = 60, 6, 4, 10
    cfg_t = TB.BuildConfig(degree=R, ex_slots=EX, ov_max=8)
    cfg_r = RB.BuildConfig(degree=R, ex_slots=EX, ov_max=8)
    graph = np.full((n, R + EX), -1, np.int32)
    degree = rng.integers(0, R + 1, n).astype(np.int32)
    for v in range(n):
        graph[v, :degree[v]] = rng.choice(n, degree[v], replace=False)
    batch = rng.choice(n, Bb, replace=False).astype(np.int32)
    out_rows = np.full((Bb, R), -1, np.int32)
    for b in range(Bb):
        m = rng.integers(2, R + 1)
        out_rows[b, :m] = rng.choice(n, m, replace=False)
    rg, rd, rov = RB._reverse_edges(jnp.asarray(graph), jnp.asarray(degree),
                                    jnp.asarray(out_rows),
                                    jnp.asarray(batch), cfg_r)
    tg, td = torch.from_numpy(graph.copy()), torch.from_numpy(degree.copy())
    tov = TB._reverse_edges(tg, td, torch.from_numpy(out_rows),
                            torch.from_numpy(batch).long(), cfg_t)
    assert np.array_equal(tg.numpy(), np.asarray(rg))
    assert np.array_equal(td.numpy(), np.asarray(rd))
    assert np.array_equal(tov.numpy(), np.asarray(rov))
    pool = rng.integers(-1, 20, (5, 30)).astype(np.int32)
    selfs = rng.integers(0, 20, 5).astype(np.int32)
    assert np.array_equal(
        TB._dedup_pool(torch.from_numpy(pool), torch.from_numpy(selfs))
        .numpy(), np.asarray(RB._dedup_pool(jnp.asarray(pool),
                                            jnp.asarray(selfs))))


@pytest.mark.parametrize("mode", ["threshold", "weight"])
def test_prune_matches_reference_on_identical_inputs(mode):
    rng = np.random.default_rng(6)
    B, C = 7, 24
    x = rng.normal(size=(B, C, 5)).astype(np.float32)
    pair = ((x[:, :, None] - x[:, None, :]) ** 2).sum(-1).astype(np.float32)
    d2 = rng.uniform(0, 10, (B, C)).astype(np.float32)
    da = rng.integers(0, 6, (B, C)).astype(np.float32)
    valid = rng.random((B, C)) < 0.85
    kw = (dict(thresholds=(9.0, 2.0, 0.0)) if mode == "threshold"
          else dict(weights=(0.0, 1.5)))
    want = RP.joint_robust_prune(jnp.asarray(valid), jnp.asarray(d2),
                                 jnp.asarray(da), jnp.asarray(pair),
                                 degree=8, alpha=1.2, **kw)
    got = TP.joint_robust_prune(torch.from_numpy(valid),
                                torch.from_numpy(d2), torch.from_numpy(da),
                                torch.from_numpy(pair), degree=8, alpha=1.2,
                                **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    ids = rng.integers(0, 100, (B, C)).astype(np.int32)
    assert np.array_equal(
        TP.select_to_rows(got, torch.from_numpy(ids), torch.from_numpy(d2),
                          8).numpy(),
        np.asarray(RP.select_to_rows(want, jnp.asarray(ids),
                                     jnp.asarray(d2), 8)))


def test_weight_mode_builds():
    tds = TS.sift_like(n=400, d=8, b=8, device="cpu")
    idx = JAGIndex.build(tds.xb, tds.attr,
                         JAGConfig(degree=8, ls_build=16, batch_size=64,
                                   cand_pool=32, mode="weight"),
                         device="cpu")
    assert len(idx.build_cfg.weights) == 2
    assert int(torch.sum(idx.graph >= 0, dim=1).max()) <= 8
    res = idx.search(tds.queries, tds.filt, k=5, ls=16)
    assert res.ids.shape == (8, 5)


def compare_builds(n: int, d: int, n_queries: int, **kw) -> dict:
    """Build the reference's index and the port's on the same
    msturing_subset data and seeds, on the CPU, and serve every query
    through the graph route of each: recall@10 against the reference's
    exact scan, build seconds and degree stats."""
    import time
    rds = RS.msturing_subset(n=n, d=d, b=n_queries, seed=3)
    tds = TS.msturing_subset(n=n, d=d, b=n_queries, seed=3, device="cpu")
    out = {"n": n, "d": d, "queries": n_queries, "config": kw}
    t0 = time.perf_counter()
    ridx = RIndex.build(rds.xb, rds.attr, RConfig(**kw))
    out["reference_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tidx = JAGIndex.build(tds.xb, tds.attr, JAGConfig(**kw), device="cpu")
    out["port_build_s"] = time.perf_counter() - t0
    gt_ids = np.asarray(ridx.executor.prefilter(jnp.asarray(rds.queries),
                                                rds.filt, k=K).ids)
    r = ridx.search(rds.queries, rds.filt, k=K, ls=LS)
    t = tidx.search(tds.queries, tds.filt, k=K, ls=LS)
    out["reference_recall"] = float(recall_at_k(
        np.asarray(r.ids), np.asarray(r.primary) == 0, gt_ids).mean())
    out["port_recall"] = float(recall_at_k(
        t.ids.numpy(), t.primary.numpy() == 0, gt_ids).mean())
    rdeg = np.asarray(ridx.graph >= 0).sum(1)
    out["reference_degree"] = dict(mean=float(rdeg.mean()),
                                   min=int(rdeg.min()), max=int(rdeg.max()))
    out["port_degree"] = tidx.degree_stats()
    return out


if __name__ == "__main__":
    # exits 1 if the port's graph-route recall is more than 0.02 below the
    # reference's
    import argparse
    import json
    import sys
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--degree", type=int, default=32)
    ap.add_argument("--ls-build", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--cand-pool", type=int, default=192)
    a = ap.parse_args()
    res = compare_builds(a.n, a.d, a.queries, degree=a.degree,
                         ls_build=a.ls_build, batch_size=a.batch_size,
                         cand_pool=a.cand_pool, ov_max=2 * a.batch_size)
    print(json.dumps(res))
    sys.exit(0 if res["port_recall"] >= res["reference_recall"] - 0.02
             else 1)


def test_kernel_entries_set_the_device_only_through_the_guard():
    """Every C entry that launches takes the caller's device through
    ``csrc/device_guard.cuh``'s ``DeviceGuard``, which restores the
    caller's current device on every return path: no source calls
    ``cudaSetDevice`` itself, and each launching entry declares the guard
    before anything else touches the card."""
    import re
    from repro_torch.kernels import _build
    header = (_build.CSRC / "device_guard.cuh").read_text()
    assert "class DeviceGuard" in header
    assert header.count("cudaSetDevice(") == 2      # set, restore
    entries = 0
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "cudaSetDevice" not in src, name
        assert '#include "device_guard.cuh"' in src, name
        for sig, body in re.findall(
                r'extern "C" \w[\w ]*?\(([^)]*)\)\s*\{(.*?)\n\}', src,
                re.S):
            if "int device" not in sig:
                continue                  # a scratch-size query
            entries += 1
            call = re.search(r"\bcuda[A-Z]\w*\(|<<<", body)   # API or launch
            guard = body.find("const DeviceGuard guard(device);")
            assert 0 <= guard and (call is None or guard < call.start()), \
                name
    # seven sources; flash_attention.cu also holds the bf16-score variant
    assert len(_build.SOURCES) == 7
    assert entries == len(_build.KERNELS) == 8
