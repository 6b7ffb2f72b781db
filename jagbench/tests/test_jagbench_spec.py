"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every part of a cell by name."""
from __future__ import annotations

import json
import re

import pytest

from jagbench.catalog import Catalog, HERE
from jagbench.tests.conftest import HELD, ROOT, with_held

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# the benchmark, and the benchmark with the held-back cells added: a later
# PR adds them with these entries, so they are held to the same contract
SPECS = {"benchmark": SPEC, "with_held": with_held(SPEC)}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("which", list(SPECS))
def test_keys_are_exactly_the_contracts(which):
    spec = SPECS[which]
    assert set(SPEC) == KEYS["top"]
    for c in spec["configs"]:
        assert set(c) == KEYS["config"], c["name"]
    for w in spec["workloads"]:
        assert set(w) == KEYS["workload"], w["name"]
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            assert set(m) - {"workloads"} == KEYS[group], m["name"]


@pytest.mark.parametrize("which", list(SPECS))
@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_units_and_lines(group, which):
    spec = SPECS[which]
    names = [e["name"] for e in spec[group]]
    assert len(names) == len(set(names))
    for e in spec[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
    if group == "configs":
        for c in spec["configs"]:
            assert len(c["reduced"]) <= 16
            assert all(NAME.match(k) for k in c["reduced"])
    if group == "workloads":
        for w in spec["workloads"]:
            assert NAME.match(w["config"]) and NAME.match(w["traffic"])
            assert w["chips"] in (1, 4)


def test_command_paths_and_sizes():
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w)
                                              for w in SPEC["command"])
    for w in SPEC["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"]), w
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= cells <= 24
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, cells // 4)


@pytest.mark.parametrize("which", list(SPECS))
def test_metrics_reach_every_cell(which):
    spec = SPECS[which]
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(spec["per_layer"]) <= 128
    for m in spec["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["bound"] >= 0.01
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        own = [m for m in spec["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in own} and len(own) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in spec["per_layer"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        listed = set(m.get("workloads", cells))
        assert listed <= cells
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert listed <= moved, m["name"]
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("which", list(SPECS))
def test_every_config_is_used_and_lies_under_paths(which):
    spec = SPECS[which]
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert used == {c["name"] for c in spec["configs"]}
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in spec["paths"])
        assert (ROOT / f).exists()
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("which", list(SPECS))
def test_the_harness_finds_every_part_by_name(which, toy_root):
    spec = SPECS[which]
    cat = (Catalog(ROOT) if which == "benchmark"
           else Catalog(toy_root, toy_root / "jagbench"))
    for w in spec["workloads"]:
        cfg = cat.config(w["config"])
        traffic = cat.traffic(w["traffic"])
        kind = cat.kind(cfg["kind"])
        assert traffic["filter"] == cfg["kind"]
        for fn in ("generate", "program_table", "program_filters",
                   "ref_rows", "ref_queries", "ref_match", "attr_words"):
            assert callable(getattr(kind, fn))
        assert set(cfg["reduced"]) == set(
            next(c for c in spec["configs"]
                 if c["name"] == w["config"])["reduced"])
        for trace in (False, True):
            for m in cat.metrics_of(w["name"], trace):
                assert callable(cat.reader(m["name"]).read)
    assert set(cat.limits()) == {"bad_ids", "empty_answers", "dist_gap",
                                 "rank_gap"}


def test_the_held_back_cells_are_not_in_the_benchmark():
    names = {w["name"] for w in SPEC["workloads"]}
    assert not names & {w["name"] for w in HELD["workloads"]}
    assert not {c["name"] for c in SPEC["configs"]} & {
        c["name"] for c in HELD["configs"]}
    assert set(HELD) == {"configs", "workloads"}


def test_each_cells_own_limits_are_found_by_its_name():
    from jagbench.harness import CHECKS
    cat = Catalog(ROOT)
    own = sorted(p.stem for p in (ROOT / "jagbench" / "limits").glob("*"))
    assert own and set(own) <= {w["name"] for w in SPECS["with_held"]
                                ["workloads"]}
    for w in own:
        lim = cat.limits(w)
        assert set(lim) <= set(CHECKS) and 0 < lim["recall_miss"] < 0.5
    # the cells whose routes are approximate hold their recall
    for w in HELD["workloads"]:
        assert "recall_miss" in cat.limits(w["name"])
    assert "recall_miss" not in cat.limits()


def test_a_cell_added_as_files_is_picked_up(toy_root):
    """A new traffic mix, a new cell and a new metric with its reader:
    files and ``BENCHMARK.json`` entries only, no other edit."""
    import torch
    from jagbench.harness import run_cell
    bench = toy_root / "jagbench"
    t = json.loads((bench / "traffic" / "label-graph.json").read_text())
    t.update(batch=32, why="a toy mix")
    (bench / "traffic" / "toy-labels.json").write_text(json.dumps(t))
    (bench / "metrics" / "toy_batches.py").write_text(
        "def read(run):\n    return len(run.batch_s)\n")
    spec = json.loads((toy_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "toy-cell", "config":
                              "sift-label-262k", "traffic": "toy-labels",
                              "chips": 1, "why": "a toy cell"})
    spec["end_to_end"].append({"name": "toy_batches", "unit": "batches",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["toy-cell"]})
    (toy_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cat = Catalog(toy_root, bench)
    res = run_cell(cat, "toy-cell", 3, 0.2, False, torch.device("cpu"),
                   0.0)
    assert res["correct"]
    assert res["attempted"] % 32 == 0
    assert res["metrics"]["toy_batches"]["value"] >= 1
    assert set(res["metrics"]) == {"toy_batches", "qps", "recall_at_10",
                                   "setup_s"}
    assert HERE != bench      # the copy, not the checkout's files, ran
