"""The control of ``correct``: the reference put in the program's place and
computed one precision below the configuration's float32 (TF32 products,
float32 distances), answering every query of a cell's pool as its exact
scan, judged by the same comparison as a run. Every seed must come out
as not correct; the readings give each limit's upper end.

    python3 jagbench/control.py --workload subset-mixed --seeds 11 12 13

One JSON line a seed on standard output: the control's readings, and
beside them the float64 reference judged against itself (the comparison's
own floor). Runs on the card (TF32 tensor cores) or, with ``--device
cpu`` at a size a test can hold, with TF32 rounding emulated.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def readings(cat, workload: str, seed: int, device, precision: str) -> dict:
    """The numbers compared for ``precision``'s answers to the whole pool
    of ``workload`` at ``seed``, with each limit and the verdict."""
    from jagbench import reference
    cell = cat.workload(workload)
    cfg, traffic = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    kind = cat.kind(cfg["kind"])
    data = kind.generate(cfg, traffic, int(seed) % (1 << 64))
    ref = reference.Reference(kind, data, device, k=traffic["search"]["k"])
    judge = reference.Judge(ref, data["queries"], data["filters"],
                            traffic["batch"])
    B, verdicts = traffic["batch"], []
    for j in range(traffic["pool"]):
        q, f = (data[x][j * B:(j + 1) * B] for x in ("queries", "filters"))
        ids, d, _ = ref.topk(q, f, precision=precision)
        prim = np.where(ids >= 0, 0.0, np.inf).astype(np.float32)
        verdicts.append(judge.judge(j, ids, prim, d.astype(np.float32),
                                    np.ones(B, bool)))
    nums = reference.summarize(verdicts, [1] * len(verdicts))
    limits = cat.limits()
    checks = {k: {"value": nums[k], "limit": limits[k]}
              for k in ("bad_ids", "empty_answers", "dist_gap", "rank_gap")}
    return {"checks": checks, "recall": nums["recall"],
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from jagbench.catalog import Catalog
    cat = Catalog(ROOT)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        row = {"workload": args.workload, "seed": seed,
               "control": readings(cat, args.workload, seed, device, "tf32"),
               "reference": readings(cat, args.workload, seed, device,
                                     "f64")}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
