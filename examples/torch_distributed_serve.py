"""Sharded JAG serving on the port: ``ShardedJAGIndex`` over a list of
devices (counterpart of ``examples/distributed_serve.py``, on
``repro_torch``).

The database is sharded row-wise across the devices (one self-contained
JAG sub-index per shard), every route runs on each shard, and the
per-shard top-k results merge exactly — [B, k] per shard gathered on the
lead device, bytes independent of N. The wrapper serves the same
``search_auto(queries, filt, k, ls)`` surface as a single-device
``JAGIndex``, so sharding is a build-time decision, not an API change:

  PYTHONPATH=src python examples/torch_distributed_serve.py [--shards 8] \
      [--n 4000] [--device cuda]

With S cards visible the shards go to ``serve_mesh(S)``, one a card;
otherwise all S shards share ``--device`` (``[device] * S``).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import JAGConfig, JAGIndex, range_filters, range_table
from repro_torch.core.filters import Label, Range, joint_table, label_table
from repro_torch.core.ground_truth import exact_filtered_knn
from repro_torch.core.recall import recall_at_k
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import serve_mesh
from repro_torch.serve.planner import PlannerConfig
from repro_torch.serve.sharded import ShardedJAGIndex


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    S, n = args.shards, args.n
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    mesh = serve_mesh(S) if n_cards >= S else [dev] * S
    n_loc, d, b, k, ls = n // S, 24, 32, 10, 48
    print(f"devices={len(set(mesh))} -> {S} shards x {n_loc} rows")

    rng = np.random.default_rng(0)
    xb = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    vals = rng.uniform(0, 1, n).astype(np.float32)
    attr = joint_table(label_table(labels, dev), range_table(vals, dev))
    cfg = JAGConfig(degree=16, ls_build=32, batch_size=256, cand_pool=64)

    # same rows, two servings: the sharded build splits rows contiguously
    # and builds one sub-graph per shard (shard_index(index, S) reshards a
    # built index the same way)
    sharded = ShardedJAGIndex.build(xb, attr, cfg, mesh=mesh)
    union = JAGIndex.build(xb, attr, cfg, device=dev)
    q = (xb[rng.integers(0, n, b)]
         + 0.1 * rng.normal(size=(b, d))).astype(np.float32)
    xt, qt = union.xb, torch.as_tensor(q, device=dev)

    # the same selectivity-adaptive surface, now fanning out across shards
    for name, hi in (("rare", 0.005), ("mid", 0.2), ("wide", 0.9)):
        filt = range_filters(np.zeros(b, np.float32),
                             np.full(b, hi, np.float32), dev)
        gt = exact_filtered_knn(xt, attr, qt, filt, k=k)
        res, plan = sharded.search_auto(q, filt, k=k, ls=ls,
                                        return_plan=True)
        rec = recall_at_k(res.ids.cpu().numpy(),
                          res.primary.cpu().numpy() == 0,
                          gt.ids.cpu().numpy()).mean()
        print(f"  band={name:4s} sel~{hi:<5} route={plan.route:10s} "
              f"recall@10={float(rec):.3f}")

    # compound expression trees dispatch through the same sharded routes
    expr = (Label(np.full(b, 2), dev) | Label(np.full(b, 3), dev)) \
        & Range(np.zeros(b, np.float32), np.full(b, 0.6, np.float32), dev)
    res, plan = sharded.search_auto(q, expr, k=k, ls=ls, return_plan=True)
    gt = exact_filtered_knn(xt, attr, qt, expr, k=k)
    rec = recall_at_k(res.ids.cpu().numpy(), res.primary.cpu().numpy() == 0,
                      gt.ids.cpu().numpy()).mean()
    print(f"  compound (2|3)&range route={plan.route} "
          f"recall@10={float(rec):.3f}")

    # exact-merge semantics: force the exact-scan route everywhere and the
    # sharded result is BIT-identical to the single-device union index —
    # same ids, same keys, same telemetry, every field
    force_exact = PlannerConfig(prefilter_max_sel=1.1,
                                postfilter_min_sel=1.2)
    a = sharded.search_auto(q, expr, k=k, ls=ls, planner=force_exact)
    bres = union.search_auto(q, expr, k=k, ls=ls, planner=force_exact)
    same = all(torch.equal(getattr(a, f).cpu(), getattr(bres, f).cpu())
               for f in a._fields)
    print(f"  exact route bit-identical to single-device union: {same}")
    print("merge collective: one gather of [B, k] per shard onto the lead "
          "device (bytes independent of N)")


if __name__ == "__main__":
    main()
