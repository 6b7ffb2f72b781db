"""The yardstick's parts: the frozen copies against their originals in the
port, the reference against brute force, the comparison against planted
faults, and the metric arithmetic."""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jagbench import datagen, readers, reference, tracestats, work
from jagbench.catalog import Catalog
from jagbench.kinds import label, subset
from jagbench.readers import nearest_rank
from jagbench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


# -- frozen copies ---------------------------------------------------------

def test_subset_generator_equals_the_ports():
    from repro_torch.data import synthetic
    from repro_torch.core.filters import unpack_bits
    want = synthetic.msturing_subset(n=700, d=12, b=40, seed=99,
                                     device="cpu")
    xb, bits, q, fbits = datagen.msturing_subset(n=700, d=12, b=40,
                                                 seed=99)
    assert np.array_equal(xb, want.xb) and np.array_equal(q, want.queries)
    assert np.array_equal(bits, unpack_bits(want.attr.data["bits"],
                                            30).numpy())
    assert np.array_equal(fbits, unpack_bits(want.filt.data["bits"],
                                             30).numpy())


def test_label_generator_equals_the_ports():
    from repro_torch.data import synthetic
    want = synthetic.sift_like(n=500, d=8, b=30, n_labels=12, seed=4,
                               device="cpu")
    xb, labels, q, qlab = datagen.sift_like(n=500, d=8, b=30, seed=4,
                                            n_labels=12)
    assert np.array_equal(xb, want.xb) and np.array_equal(q, want.queries)
    assert np.array_equal(labels, want.attr.data["label"].numpy())
    assert np.array_equal(qlab, want.filt.data["label"].numpy())


def test_balanced_batches_share_one_multiset():
    _, _, _, fbits = datagen.msturing_subset(n=300, d=4, b=3 * 70, seed=1,
                                             balanced_batch=70)
    ks = fbits.sum(1).reshape(3, 70)
    for row in ks:
        assert sorted(row) == sorted(np.resize([0, 2, 4, 6, 8, 10, 12], 70))
    assert not np.array_equal(ks[0], ks[1])     # the order is drawn
    # the draws before the filters are the uniform draw's
    a = datagen.msturing_subset(n=300, d=4, b=140, seed=1)
    b = datagen.msturing_subset(n=300, d=4, b=140, seed=1,
                                balanced_batch=70)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_work_formulas_equal_the_ports(workload):
    from repro_torch.launch import roofline
    cat = Catalog(ROOT)
    cell = cat.workload(workload)
    cfg, traffic = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    n, d, B = cfg["n"], cfg["d"], traffic["batch"]
    for b in (1, B // 7, B // 2, B):
        for shape in (dict(B=b, tile=4096, dp=d + (-d) % 8),
                      dict(B=b, tile=n, dp=d)):
            assert (work.kernel_work("gather_dist_tile", **shape)
                    == roofline.kernel_work("gather_dist_tile", **shape))
        shape = dict(B=b, N=n, W=subset.attr_words(cfg) if cfg["kind"] ==
                     "subset" else 1, popc_rate=work.POPC_RATE)
        assert (work.kernel_work("bitset_dist", **shape)
                == roofline.kernel_work("bitset_dist", **shape))
    assert work.POPC_RATE == roofline.popc_ops_per_s(132, 1980)
    for key in ("hbm_bw", "fp32_flops", "popc_per_clock"):
        assert work.PEAKS[key] == roofline.HW[key]


def _events():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
           "dur": 40, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 50,
           "dur": 30, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
           "ts": 80, "dur": 30, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "void k1<float>(float*)",
           "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "void ns::k2(int)", "ts": 25,
           "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90,
           "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "void k1<float>(float*)",
           "ts": 100, "dur": 10}]
    return ev


def test_trace_arithmetic_equals_the_ports():
    from repro_torch.launch import trace_stats
    ev = _events()
    for wall in (None, 200.0):
        assert (tracestats.profile_stats(ev, wall)
                == trace_stats.profile_stats(ev, wall))
    st = tracestats.profile_stats(ev, 200.0)
    assert st["device_busy_us"] == 25 + 5 + 10
    assert tracestats.idle_intervals(ev) == [(0.0, 10.0), (35.0, 90.0),
                                             (95.0, 100.0)]
    assert dict(tracestats.device_ops(st)) == pytest.approx(
        {"k1": 30e-6, "k2": 10e-6})
    # midpoints: 5 in aten::mm, 62.5 in aten::sort, 97.5 in no host op
    assert dict(tracestats.idle_by_host_op(ev)) == pytest.approx(
        {"aten::mm": 10e-6, "aten::sort": 55e-6, "python": 5e-6})
    assert tracestats.short_name(
        "void at::native::(anonymous namespace)::indexSelectLargeIndex"
        "<float, long, 2>(at::cuda::TensorInfo<float, unsigned int>)"
    ) == "indexSelectLargeIndex"


# -- the reference -----------------------------------------------------------

@pytest.mark.parametrize("kind", [subset, label])
def test_reference_top10_equals_brute_force(kind):
    cfg = dict(n=900, d=10, n_attrs=30, n_labels=12)
    traffic = dict(batch=40, pool=2, required_bits=[0, 2, 4, 6, 8, 10, 12])
    data = kind.generate(cfg, traffic, 8)
    ref = reference.Reference(kind, data, torch.device("cpu"))
    ids, d, n_match = ref.topk(data["queries"], data["filters"])
    x = data["xb"].astype(np.float64)
    for b, q in enumerate(data["queries"].astype(np.float64)):
        if kind is subset:
            f = data["filters"][b]
            ok = np.all((data["rows"] & f) == f, axis=1)
        else:
            ok = data["rows"] == data["filters"][b]
        dist = ((x - q) ** 2).sum(1)
        cand = np.flatnonzero(ok)
        best = cand[np.argsort(dist[cand], kind="stable")][:10]
        assert n_match[b] == ok.sum()
        assert list(ids[b][:len(best)]) == list(best)
        assert np.all(ids[b][len(best):] == -1)
        assert np.allclose(d[b][:len(best)], dist[best], rtol=1e-12)


@pytest.fixture(scope="module")
def judged():
    cfg = dict(n=800, d=12, n_attrs=30)
    traffic = dict(batch=30, pool=1, required_bits=[0, 2, 4, 6, 8])
    data = subset.generate(cfg, traffic, 21)
    ref = reference.Reference(subset, data, torch.device("cpu"))
    judge = reference.Judge(ref, data["queries"], data["filters"], 30)
    ids, d, _ = judge.want[0]
    prim = np.where(ids >= 0, 0.0, np.inf).astype(np.float32)
    return judge, ids, prim, d.astype(np.float32)


def test_the_exact_answer_passes(judged):
    judge, ids, prim, d = judged
    v = judge.judge(0, ids, prim, d, np.ones(30, bool))
    nums = reference.summarize([v], [1])
    assert nums["bad_ids"] == 0 and nums["empty_answers"] == 0
    assert nums["dist_gap"] < 1e-7 and nums["rank_gap"] < 1e-7
    assert nums["recall"] == 1.0


def test_planted_faults_are_read(judged):
    judge, ids, prim, d = judged
    scanned = np.ones(30, bool)

    def nums(i, p, dd, c=1):
        return reference.summarize([judge.judge(0, i, p, dd, scanned)], [c])
    # an id that fails its filter, in a query that requires some tags
    b = int(np.flatnonzero(judge.filters[:, 0])[0])
    f = judge.filters[b]
    fail = int(np.flatnonzero(np.any((judge.ref.rows.numpy() & f) != f,
                                     axis=1))[0])
    i2 = ids.copy()
    i2[b, 0] = fail
    assert nums(i2, prim, d)["bad_ids"] >= 1
    # a repeated id
    i3 = ids.copy()
    i3[1, 1] = i3[1, 0]
    assert nums(i3, prim, d)["bad_ids"] >= 1
    # half of the batch answered with nothing
    i4, p4 = ids.copy(), prim.copy()
    i4[15:], p4[15:] = -1, np.inf
    assert nums(i4, p4, d)["empty_answers"] == 15
    # a distance off by a tenth of a percent
    d5 = d.copy()
    d5[2, 3] *= 1.001
    out = nums(ids, prim, d5)
    assert out["dist_gap"] > 5e-4 and out["rank_gap"] > 5e-4
    # a scanned answer that skips the true nearest: every rank after it
    i6, d6 = ids.copy(), d.copy()
    i6[3, :-1], d6[3, :-1] = ids[3, 1:], d[3, 1:]
    i6[3, -1], d6[3, -1] = -1, np.inf
    assert nums(i6, prim, d6)["rank_gap"] > 1e-3
    assert nums(i6, prim, d6)["recall"] < 1.0
    # counts weight the servings
    assert nums(i4, p4, d, c=3)["empty_answers"] == 45


def test_the_control_rounds_to_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, 3.0])
    assert reference._tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]


# -- the metrics' arithmetic ------------------------------------------------

def _reader(name):
    return Catalog(ROOT).reader(name).read


def test_qps_is_all_work_over_all_time():
    run = SimpleNamespace(batch_queries=[100, 100, 100, 100],
                          batch_s=[0.1, 0.1, 0.1, 0.7], window_s=1.0)
    assert _reader("qps")(run) == 400.0       # not the mean rate, 2,571


def test_the_tail_is_over_all_batches():
    lat = [0.010] * 85 + [0.020] * 10 + [0.500] * 5
    run = SimpleNamespace(batch_s=lat)
    # chunks of 10 would give medians of 10 ms; the 90th of all is 20 ms
    assert _reader("batch_p90_ms")(run) == pytest.approx(20.0)
    assert nearest_rank(list(range(1, 101)), 90) == 90
    assert nearest_rank([5.0], 90) == 5.0


def test_route_times_and_plan_share():
    groups = [[("prefilter", 500, 0.010), ("graph", 300, 0.100)],
              [("graph", 200, 0.050)]]
    run = SimpleNamespace(groups=groups, batch_s=[0.120, 0.060])
    assert readers.route_ms_per_kq(run, "graph") == pytest.approx(300.0)
    assert _reader("route_ms_per_kq.prefilter")(run) == pytest.approx(20.0)
    assert readers.route_ms_per_kq(run, "postfilter") is None
    assert _reader("plan_dispatch_ms")(run) == pytest.approx(10.0)


def test_rooflines_read_nothing_without_their_kernel():
    stats = {"kernels": {"void gather_dist_tile_kernel(float*)":
                        {"calls": 2, "device_ms": 4.0}},
             "device_busy_us": 8e3}
    run = SimpleNamespace(prof=dict(stats=stats, scanned=[100, 0],
                                    wall_s=0.01), n=4096, d=100, words=1)
    share = _reader("gather_dist_tile_roofline")(run)
    want = work.scan_bound_s("gather_dist_tile", 100, 4096, 100, 1)
    assert share == pytest.approx(100 * want / 4e-3)
    assert _reader("bitset_dist_roofline")(run) is None
    assert _reader("device_idle_pct")(run) == pytest.approx(20.0)
