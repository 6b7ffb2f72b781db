"""Readings of the recall check under planted faults of the beam search:
the search's own parameters cut where the program takes them, so that the
graph and postfilter routes return ids that pass the filter, with their
true distances, but far from the query. Each must read past the cell's
``recall_miss`` limit; the sound search beside them gives its lower end.

    python3 jagbench/faults.py --workload label-graph --seeds 11 12

One JSON line a seed on standard output: for the sound search and each
fault, the numbers compared over the whole pool at the cell's size, on
one index built as a run builds it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# the search as the cell states it, and each fault as what it changes
FAULTS = {"sound": {}, "ls_half": {"ls": 32}, "iters_2": {"max_iters": 2}}


def readings(cat, workload: str, seed: int, device) -> dict:
    """The numbers compared for each of ``FAULTS`` over ``workload``'s
    pool at ``seed``."""
    import numpy as np
    import torch
    from repro_torch.core.jag import JAGConfig, JAGIndex

    from jagbench import reference
    from jagbench.harness import CHECKS, Client
    cell = cat.workload(workload)
    cfg, traffic = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    kind, limits = cat.kind(cfg["kind"]), cat.limits(workload)
    data = kind.generate(cfg, traffic, int(seed) % (1 << 64))
    xb = torch.as_tensor(data["xb"], device=device)
    jcfg = JAGConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in cfg["index"].items()})
    idx = JAGIndex.build(xb, kind.program_table(data, cfg, device), jcfg,
                         device=device)
    judge = reference.Judge(reference.Reference(kind, data, device,
                                                k=traffic["search"]["k"]),
                            data["queries"], data["filters"],
                            traffic["batch"])
    out = {}
    for name, change in FAULTS.items():
        t = dict(traffic, search={**traffic["search"], **change})
        client = Client(idx, kind, cfg, t, data, device)
        verdicts = []
        for j in range(traffic["pool"]):
            ids, prim, sec, routes = client.serve(j)
            verdicts.append(judge.judge(j, ids, prim, sec,
                                        np.asarray(routes) == "prefilter"))
        nums = reference.summarize(verdicts, [1] * len(verdicts))
        checks = {k: {"value": nums[k], "limit": limits[k]}
                  for k in CHECKS if k in nums and k in limits}
        out[name] = {"checks": checks,
                     "correct": all(c["value"] <= c["limit"]
                                    for c in checks.values())}
    return out


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
               **readings(cat, args.workload, seed, device)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
