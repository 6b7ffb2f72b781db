"""The port's launch layer on the CPU: the training launcher's crash and
resume (``repro_torch.launch.train``, the subprocess contract of
``tests/test_fault_tolerance.py``), the dry run on the meta device
(``repro_torch.launch.dryrun``, one cell per family) and the perf
harness's variant functions at a tiny size (``repro_torch.launch.perf``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs.shapes import JAG_SHAPES
from repro_torch.launch import dryrun, perf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_crash_resume_subprocess(tmp_path):
    """Kill training mid-run; rerun must resume and finish identically
    (the reference's contract, on ``--device cpu``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-1.7b", "--scale", "reduced", "--steps", "12",
            "--batch", "2", "--seq", "32", "--ckpt-every", "4",
            "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck"),
            "--metrics-out", str(tmp_path / "m1.jsonl")]
    r = subprocess.run(base + ["--fail-at-step", "6"], env=env,
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 42, r.stderr[-2000:]
    assert latest_step(str(tmp_path / "ck")) == 4
    r2 = subprocess.run(base, env=env, capture_output=True, text=True,
                        cwd=ROOT)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 4" in r2.stdout
    assert latest_step(str(tmp_path / "ck")) == 12

    # a never-crashed control run sees the same data and converges the same
    r3 = subprocess.run(
        [*base[:-2], "--ckpt-dir", str(tmp_path / "ck3"),
         "--metrics-out", str(tmp_path / "m3.jsonl")],
        env=env, capture_output=True, text=True, cwd=ROOT)
    assert r3.returncode == 0, r3.stderr[-2000:]
    m1 = [json.loads(l) for l in open(tmp_path / "m1.jsonl")]
    m3 = [json.loads(l) for l in open(tmp_path / "m3.jsonl")]
    last1 = [m for m in m1 if m["step"] == 11][-1]
    last3 = [m for m in m3 if m["step"] == 11][-1]
    assert abs(last1["loss"] - last3["loss"]) < 2e-2, (last1, last3)


@pytest.mark.parametrize("arch,shape,status", [
    ("qwen3-1.7b", "decode_32k", "ok"), ("fm", "serve_p99", "ok"),
    ("gcn-cora", "molecule", "ok"), ("jag", "serve_1b", "analytic_only")])
def test_dryrun_cell_per_family(arch, shape, status, capsys):
    rows = [dryrun.run_cell(arch, shape, m) for m in dryrun.MESHES]
    out = capsys.readouterr().out
    for row, cards in zip(rows, (256, 512)):
        assert row["status"] == status and row["n_cards"] == cards
        assert row["fits"] and row["state_bytes"]["total"] > 0
        assert row["t_comp_s"] == pytest.approx(
            row["model_flops"] / cards / 989e12)
        json.dumps(row)
    if status == "analytic_only":
        assert "analytic only:" in out and rows[0]["reason"]
    # more cards hold less of the state each
    assert rows[1]["state_bytes"]["total"] <= rows[0]["state_bytes"]["total"]


def test_dryrun_cli_exit_codes(tmp_path, monkeypatch):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "gcn-cora", "--shape", "molecule",
                        "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert len(got["results"]) == 2 and not got["failures"]
    # a step that fails on meta fails its cell and the run
    real = dryrun.make_cell

    def broken(*a, **k):
        cell = real(*a, **k)

        def fail(*args):
            raise RuntimeError("host read")
        cell["fn"] = fail
        return cell
    monkeypatch.setattr(dryrun, "make_cell", broken)
    dryrun._META_RUNS.clear()
    assert dryrun.main(["--arch", "fm", "--shape", "serve_p99",
                        "--mesh", "single"]) == 1


def test_perf_variants_at_a_tiny_size():
    rows = []
    shp = dict(JAG_SHAPES["serve_1b"], max_iters=12, ls=16, d=16)
    data = perf.jag_serve_data("cpu", n_local=2048, queries=256, shape=shp)
    perf.jag_serve_variants(rows, "cpu", data=data, n_local=2048, steps=1)
    assert [r["tag"] for r in rows] == [v[0] for v in perf.JAG_VARIANTS]
    assert all(r["results_ok"] and r["qps"] > 0 for r in rows)
    assert [r["row_width"] for r in rows] == [80] * 4 + [64]
    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab=512)
    perf.lm_train_variants("qwen3-1.7b", rows, "cpu", batch=4, seq=32,
                           steps=1, shrink=small, check_plain=True)
    lm = rows[-2:]
    assert [r["tag"] for r in lm] == [v[0] for v in perf.LM_VARIANTS]
    assert all(r["finite"] and r["batch"] == 4 and r["seq"] == 32
               for r in lm)
    # on the CPU the step's attention is the plain version itself
    assert all(abs(r["losses"][0] - r["plain_loss"]) <= 1e-5 * r["plain_loss"]
               for r in lm)
    perf.din_train_variants(rows, "cpu", steps=1, batch=256,
                            shrink=dict(total_vocab=4096, seq_len=16))
    din = rows[-4:]
    assert [r["tag"] for r in din] == [v[0] for v in perf.DIN_VARIANTS]
    assert all(r["finite"] for r in din)
    # the bf16 table halves the table's bytes a card; rows@model only
    # splits it 16 ways instead of 256
    sb = [r["state_bytes_16x16"]["params"] for r in din]
    assert sb[1] < sb[0] and sb[2] > sb[0] and sb[3] < sb[2]
    json.dumps(rows, default=str)
