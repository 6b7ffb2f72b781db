"""Runs of each cell's path on the CPU at a toy size: the result line, the
exits without a card or without the program, the faults that must turn
``correct`` false, the control, and the import purity of a whole run."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from jagbench import control, faults
from jagbench.catalog import Catalog
from jagbench.harness import run_cell
from jagbench.tests.conftest import ROOT, make_toy, with_held

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# the toy runs take the held-back cells too (``conftest.make_toy``)
CELLS = [w["name"] for w in with_held(SPEC)["workloads"]]
BENCH_CELLS = [w["name"] for w in SPEC["workloads"]]
CPU = torch.device("cpu")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_toy_run_prints_the_contracts_line(toy_root, capsys, workload,
                                             trace):
    from jagbench import run
    rc = run.main(["--workload", workload, "--seed", "4294967311",
                   "--seconds", "0.3", "--trace", str(trace)],
                  root=toy_root, device=CPU)
    assert rc == 0
    line = _last_line(capsys)
    keys = LINE_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["attempted"] % 56 == 0
    cat = Catalog(toy_root, toy_root / "jagbench")
    want = {m["name"]: m["unit"] for m in cat.metrics_of(workload, trace)}
    got = {k: v["unit"] for k, v in line["metrics"].items()}
    if trace:      # no device events on the CPU: those readers are silent
        assert got.items() <= want.items() and "build_s" in got
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert got == want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"}
               for c in line["checks"].values())


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "jagbench/run.py", "--workload",
                        BENCH_CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_with_only_the_benchmark_there_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "jagbench", tmp_path / "jagbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "jagbench/run.py", "--workload",
                        BENCH_CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


# -- the timed path broken underneath: correct must come out false ---------

def _stale(orig):
    """A search that hands back the previous call's answers."""
    last = []

    def search_auto(self, *a, **kw):
        out = orig(self, *a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return search_auto


def _half(orig):
    """A search that answers only the first half of the batch."""
    def search_auto(self, *a, **kw):
        res, plan = orig(self, *a, **kw)
        h = res.ids.shape[0] // 2
        ids, prim = res.ids.clone(), res.primary.clone()
        ids[h:], prim[h:] = -1, float("inf")
        return res._replace(ids=ids, primary=prim), plan
    return search_auto


def _altered(route):
    """The route's answers altered where they are produced: every id moved
    to its neighbour row, the distances left as they were."""
    from repro_torch.serve.executor import Executor
    orig = getattr(Executor, route)

    def fn(self, *a, **kw):
        res = orig(self, *a, **kw)
        n = self.index.xb.shape[0]
        ids = torch.where(res.ids >= 0, (res.ids + 1) % n, res.ids)
        return res._replace(ids=ids.to(res.ids.dtype))
    return fn


@pytest.mark.parametrize("fault", ["stale", "half", "graph", "prefilter",
                                   "postfilter"])
def test_a_broken_path_is_not_correct(toy_root, monkeypatch, fault):
    from repro_torch.core.jag import JAGIndex
    from repro_torch.serve.executor import Executor
    if fault in ("stale", "half"):
        wrap = _stale if fault == "stale" else _half
        monkeypatch.setattr(JAGIndex, "search_auto",
                            wrap(JAGIndex.search_auto))
    else:
        monkeypatch.setattr(Executor, fault, _altered(fault))
    cat = Catalog(toy_root, toy_root / "jagbench")
    # a window of several batches: the first one's stale answers are the
    # warm-up's answers to the same batch
    res = run_cell(cat, "subset-mixed", 77, 2.0, False, CPU, 0.0)
    assert res["attempted"] >= 2 * 56
    assert res["correct"] is False and res["failed"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _shallow(orig):
    """A beam search cut to two iterations where the program takes its
    parameters: ids that pass the filter, with their true distances, far
    from the query."""
    def search_auto(self, *a, **kw):
        return orig(self, *a, **{**kw, "max_iters": 2})
    return search_auto


GRAPH_CELLS = [w for w in CELLS if (ROOT / "jagbench" / "limits"
                                    / f"{w}.json").exists()]


@pytest.mark.parametrize("workload", GRAPH_CELLS)
def test_a_shallow_beam_search_is_not_correct(toy_root, monkeypatch,
                                              workload):
    from repro_torch.core.jag import JAGIndex
    monkeypatch.setattr(JAGIndex, "search_auto",
                        _shallow(JAGIndex.search_auto))
    cat = Catalog(toy_root, toy_root / "jagbench")
    res = run_cell(cat, workload, 77, 0.3, False, CPU, 0.0)
    c = res["checks"]
    assert c["bad_ids"]["value"] == 0 and c["dist_gap"]["value"] < 1e-4
    assert c["recall_miss"]["value"] > c["recall_miss"]["limit"]
    assert res["correct"] is False


@pytest.mark.parametrize("workload", GRAPH_CELLS)
def test_the_fault_readings_separate(toy_root, workload):
    cat = Catalog(toy_root, toy_root / "jagbench")
    got = faults.readings(cat, workload, 31, CPU)
    assert set(got) == set(faults.FAULTS)
    assert got["sound"]["correct"] is True
    assert got["iters_2"]["correct"] is False
    miss = {k: v["checks"]["recall_miss"]["value"] for k, v in got.items()}
    assert miss["sound"] < miss["ls_half"] < miss["iters_2"]


def test_the_sound_path_is_correct(toy_root):
    cat = Catalog(toy_root, toy_root / "jagbench")
    res = run_cell(cat, "subset-mixed", 77, 0.3, False, CPU, 0.0)
    assert res["correct"] is True and res["failed"] == 0


# -- the control: the reference one precision below, in the program's place

@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tmp_path, workload):
    root = make_toy(tmp_path, n=6000)
    cat = Catalog(root, root / "jagbench")
    low = control.readings(cat, workload, 31, CPU, "tf32")
    assert low["correct"] is False
    assert low["checks"]["dist_gap"]["value"] > 3 * cat.limits()["dist_gap"]
    own = control.readings(cat, workload, 31, CPU, "f64")
    assert own["correct"] is True and own["recall"] == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(tmp_path, cuda_device,
                                                workload):
    root = make_toy(tmp_path, n=20000)
    cat = Catalog(root, root / "jagbench")
    low = control.readings(cat, workload, 31, cuda_device, "tf32")
    assert low["correct"] is False
    own = control.readings(cat, workload, 31, cuda_device, "f64")
    assert own["correct"] is True


# -- what a whole run loads and opens ---------------------------------------

PURITY = r"""
import json, os, sys
from pathlib import Path
opened = []
bench = os.path.join({root!r}, "benchmarks")
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        p = os.path.abspath(os.fsdecode(args[0]))
        if p.startswith(bench + os.sep) or p == bench:
            opened.append(p)
sys.addaudithook(hook)
sys.path[:0] = [{root!r}, os.path.join({root!r}, "src")]
import torch
from jagbench import run
rc = run.main(["--workload", {cell!r}, "--seed", "5", "--seconds", "0.2",
               "--trace", "1"], root=Path({toy!r}), device=torch.device("cpu"))
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print("PURITY " + json.dumps({{"rc": rc, "tops": tops, "opened": opened}}))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_loads_no_jax_and_reads_no_jax_benchmark(tmp_path, workload):
    toy = make_toy(tmp_path)
    code = PURITY.format(root=str(ROOT), cell=workload, toy=str(toy))
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    line = [s for s in p.stdout.splitlines() if s.startswith("PURITY ")]
    assert line, p.stderr[-3000:]
    got = json.loads(line[-1][len("PURITY "):])
    assert got["rc"] == 0
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in got["tops"] and "jagbench" in got["tops"]
    assert got["opened"] == []


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    from jagbench.harness import forbidden_modules
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in forbidden_modules()
