"""Fixtures of the benchmark's own tests (CPU; the ``gpu`` ones skip
without a card, decided inside ``cuda_device``).

``toy_root`` is a copy of the checkout's ``BENCHMARK.json``, with the
cells of ``held_back.json`` added, and of ``jagbench/`` in a temporary
directory with every configuration and traffic mix cut to a size the CPU
runs in seconds: the same files, the same keys, smaller numbers.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY_N = 1200


HELD = json.loads((ROOT / "jagbench" / "held_back.json").read_text())


def with_held(spec: dict) -> dict:
    """``spec`` with the cells held back from it (``held_back.json``)
    added, as a later ``BENCHMARK.json`` would add them."""
    out = dict(spec)
    for group in ("configs", "workloads"):
        out[group] = spec[group] + HELD[group]
    return out


def make_toy(dst: Path, n: int = TOY_N) -> Path:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(with_held(spec)))
    shutil.copytree(ROOT / "jagbench", dst / "jagbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dst / "jagbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(n=n, d=16)
        c["index"].update(degree=16, ls_build=32, batch_size=256,
                          cand_pool=64, ov_max=512)
        f.write_text(json.dumps(c))
    for f in (dst / "jagbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(batch=56, pool=3, warmup_batches=1)
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture
def toy_root(tmp_path) -> Path:
    return make_toy(tmp_path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
