#!/usr/bin/env python3
"""Run the six examples of the port (``examples/torch_*.py``) at their
defaults, one process each, and print each one's output and wall seconds,
beside the card's name and power limit.

    python3 tools/run_torch_examples.py

Each example runs with this checkout's ``src`` on its path and its
temporary files under a directory of its own; the seconds are the host
clock around the whole process (imports, the kernels' build where the
cache is cold, and the example's work). Without a card each example
fails, as it does when run alone. Exits 1 if any example fails.
"""
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "compound_filters", "filtered_search_e2e",
         "distributed_serve", "recsys_retrieval_jag", "train_lm")


def main() -> int:
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[card] {smi.stdout.strip() or smi.stderr.strip()}",
              flush=True)
    failed = []
    for name in NAMES:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       TMPDIR=tmp)
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, str(ROOT / "examples" / f"torch_{name}.py")],
                env=env, capture_output=True, text=True)
            dt = time.perf_counter() - t0
        print(f"=== torch_{name}.py: exit {r.returncode}, {dt:.1f} s",
              flush=True)
        print(r.stdout.rstrip(), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            failed.append(name)
    print(f"[examples] {len(NAMES) - len(failed)} of {len(NAMES)} ran; "
          f"failed: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
