"""Compound filter expressions on the port: AND/OR/NOT trees over a
composite index (counterpart of ``examples/compound_filters.py``, on
``repro_torch``).

Builds one JAG over a joint label+range attribute table, then serves a
compound filter — ``(Label(9) | Label(1)) & Range(lo, hi)`` — through
``search_auto``, printing the plan (composed selectivity, chosen route)
and recall against exact ground truth. Finishes with the clause-reorder
demo: the planner rewrites a worst-order AND so the most selective
clause runs first, cutting short-circuit filter evaluations without
changing a single result id.

  PYTHONPATH=src python examples/torch_compound_filters.py [--n 8000] \
      [--device cuda]
"""
import argparse

import numpy as np
import torch

import repro_torch as rt
from repro_torch.core import filters as F
from repro_torch.core.recall import recall_at_k
from repro_torch.device import resolve_device
from repro_torch.serve.planner import (PlannerConfig, explain,
                                       leaf_selectivities, reorder_clauses)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    n, d, b, k = args.n, 32, 64, 10

    rng = np.random.default_rng(0)
    xb = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    labels[: n // 100] = 9                       # rare label, sel ~1%
    rng.shuffle(labels)
    vals = rng.uniform(0, 1, n).astype(np.float32)
    attr = rt.joint_table(rt.label_table(labels, dev),
                          rt.range_table(vals, dev))
    index = rt.JAGIndex.build(xb, attr, rt.JAGConfig(degree=24), device=dev)
    q = (xb[rng.integers(0, n, b)]
         + 0.1 * rng.normal(size=(b, d))).astype(np.float32)
    xt, qt = index.xb, torch.as_tensor(q, device=dev)

    # one tree, every route: leaves are batched lanes, operators compose
    zeros = np.zeros(b, np.float32)
    expr = ((rt.Label(np.full(b, 9), dev) | rt.Label(np.full(b, 1), dev))
            & rt.Range(zeros, np.full(b, 0.7, np.float32), dev))
    gt = rt.exact_filtered_knn(xt, attr, qt, expr, k=k)
    res, p = index.search_auto(q, expr, k=k, return_plan=True)
    rec = recall_at_k(res.ids.cpu().numpy(), res.primary.cpu().numpy() == 0,
                      gt.ids.cpu().numpy()).mean()
    print(explain(p, PlannerConfig(), filt=expr))
    print(f"compound search_auto: recall@{k}={rec:.3f}")

    # clause reordering: same ids, fewer short-circuit evaluations
    fixed = (rt.Range(zeros, np.full(b, 0.9, np.float32), dev)
             & rt.Label(np.full(b, 9), dev))
    sels = np.median(leaf_selectivities(
        fixed, attr, torch.arange(n, device=dev)).cpu().numpy(), axis=1)
    better = reorder_clauses(fixed, sels)
    gt0 = rt.exact_filtered_knn(xt, attr, qt, fixed, k=k)
    gt1 = rt.exact_filtered_knn(xt, attr, qt, better, k=k)
    same = torch.equal(gt0.ids, gt1.ids)
    print(f"reorder {F.describe(fixed)} -> {F.describe(better)}: "
          f"n_feval {float(gt0.n_feval.float().mean()):.0f} -> "
          f"{float(gt1.n_feval.float().mean()):.0f}, "
          f"ids identical: {same}")


if __name__ == "__main__":
    main()
