"""Run one cell of the benchmark once and print its result line.

    python3 jagbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds the program (``src/repro_torch``)
beside ``BENCHMARK.json``. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones from a run with per-group waits
and a profiled stretch. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit); the same numbers end standard error. Progress
goes to standard error.

A run is one process on a fixed set of cores (``CORES``), with as many
threads a pool and a fixed hash seed: two runs differ only in what the
host does around them.

Exits 2 without a result where torch sees no CUDA device or fewer than
the cell asks for, and 3 where JAX or the JAX package (``repro``) was
loaded once the window has closed; 1 where the checkout has no program.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _log(msg: str) -> None:
    print(f"[jagbench {time.perf_counter() - T_START:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _caches() -> None:
    """Every cache of a kernel toolchain at a fixed path in the checkout.
    The program's own nvcc builds go to ``src/repro_torch/_build``."""
    cache = ROOT / ".jagbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


CORES = 4     # the run's fixed share of the host: cores, and threads a pool


def _steady() -> None:
    """One process on a fixed set of cores, with as many threads a pool
    and a fixed hash seed. Re-executes itself once to fix the hash
    seed."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, *sys.argv])
    cpus = sorted(os.sched_getaffinity(0))[-CORES:]
    os.sched_setaffinity(0, cpus)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(len(cpus))


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """The command; ``root`` and ``device`` let a test drive a run on the
    CPU over a toy copy of the checkout, past the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        _log(f"no program beside the benchmark: {ROOT / 'src/repro_torch'} "
             f"is missing")
        return 1
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from jagbench.catalog import Catalog
    from jagbench.harness import forbidden_modules, run_cell

    cat = Catalog(root, Path(root) / "jagbench")
    cell = cat.workload(args.workload)
    if device is None:
        chips = int(cell.get("chips", 1))
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            _log(f"needs {chips} CUDA device(s), torch sees {n}: no result")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.set_num_threads(len(os.sched_getaffinity(0)))
    _log(f"{args.workload}: seed {args.seed}, {args.seconds} s, trace "
         f"{args.trace}, {device}")
    result = run_cell(cat, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START, _log)
    bad = forbidden_modules()
    if bad:
        _log(f"loaded the JAX package or JAX: {bad}; no result")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    import json
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _steady()
    sys.exit(main())
