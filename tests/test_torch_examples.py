"""The six examples on the port (``examples/torch_*.py``) on the CPU, each
at a tiny size in a subprocess of its own (no ``XLA_FLAGS``, one thread,
``TMPDIR`` under the test's directory): exit 0 and the reference
example's key lines. The recall floors are 0.8 (1.0 on the exact route);
the reference examples print no floor of their own, and their test of the
sharded step holds 0.75 (``tests/test_distributed.py``). Without
``--device`` every example asks for the card and fails here, where none
is visible.
"""
import ast
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLOOR = 0.8
ARGS = {
    "quickstart": ["--n", "1000"],
    "compound_filters": ["--n", "1000"],
    "filtered_search_e2e": ["--n", "600"],
    "distributed_serve": ["--n", "1600", "--shards", "4"],
    "recsys_retrieval_jag": ["--n", "1500"],
    "train_lm": ["--steps", "2"],
}


def _run(name, args, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), *args],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    return r.returncode, r.stdout, r.stdout[-3000:] + r.stderr[-3000:]


def _floats(pattern, out):
    return [float(x) for x in re.findall(pattern, out)]


def _check(name, out):
    if name == "quickstart":
        rec, = _floats(r"recall@10 = ([\d.]+)", out)
        assert rec > FLOOR
        assert "save/load round-trip OK" in out
    elif name == "compound_filters":
        rec, = _floats(r"compound search_auto: recall@10=([\d.]+)", out)
        assert rec > FLOOR
        assert "route=" in out and "ids identical: True" in out
    elif name == "filtered_search_e2e":
        for fig in ("range (Fig.1)", "label (Fig.3)", "subset (Fig.4)",
                    "boolean (Fig.5)"):
            line, = [x for x in out.splitlines() if x.startswith(fig)]
            jag, auto, _ = _floats(r"recall=([\d.]+)", line)
            assert jag > FLOOR and auto > FLOOR, line
    elif name == "distributed_serve":
        assert "4 shards x 400 rows" in out
        bands = re.findall(r"band=(\w+)\s+sel~\S+\s+route=(\w+)\s+"
                           r"recall@10=([\d.]+)", out)
        assert [b[0] for b in bands] == ["rare", "mid", "wide"]
        for _, route, rec in bands:
            assert float(rec) >= (1.0 if route == "prefilter" else FLOOR)
        rec, = _floats(r"compound \(2\|3\)&range route=\w+ "
                       r"recall@10=([\d.]+)", out)
        assert rec > FLOOR
        assert ("exact route bit-identical to single-device union: True"
                in out)
    elif name == "recsys_retrieval_jag":
        rec, = _floats(r"candidate recall@50 = ([\d.]+)", out)
        assert rec > FLOOR
        assert "stage-2 ranked; example user 0 -> item" in out
    else:
        assert re.search(r"step +0 loss", out) and re.search(r"step +1 loss",
                                                            out)
        loss, = _floats(r"\[train\] done; final loss ([\d.]+)", out)
        assert math.isfinite(loss)


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_runs_on_the_cpu(name, tmp_path):
    rc, out, tail = _run(name, ARGS[name] + ["--device", "cpu"], tmp_path)
    assert rc == 0, tail
    _check(name, out)


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_asks_for_the_card_by_default(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc, out, tail = _run(name, ARGS[name], tmp_path)
    assert rc != 0
    assert "torch sees no GPU" in tail
    assert "recall" not in out and "loss" not in out


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_imports_neither_jax_nor_repro(name):
    tree = ast.parse((ROOT / "examples" / f"torch_{name}.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    roots = {m.split(".")[0] for m in mods}
    assert "repro_torch" in roots and not roots & {"jax", "repro"}, roots
