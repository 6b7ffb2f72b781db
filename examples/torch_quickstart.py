"""Quickstart on the port: build a JAG over vectors+attributes, run filtered
queries (counterpart of ``examples/quickstart.py``, on ``repro_torch``).

  PYTHONPATH=src python examples/torch_quickstart.py [--n 5000] \
      [--device cuda]

Runs on the card by default and raises if none is visible; ``--device
cpu`` runs it on the CPU.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import (JAGConfig, JAGIndex, exact_filtered_knn,
                         range_filters, range_table)
from repro_torch.core.recall import recall_at_k
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, d = args.n, 32

    # vectors + a scalar attribute per point (e.g. price, timestamp)
    xb = rng.normal(size=(n, d)).astype(np.float32)
    prices = rng.uniform(0, 1000, n).astype(np.float32)

    print("building Threshold-JAG (thresholds = {100%, 1%, 0} quantiles)...")
    index = JAGIndex.build(xb, range_table(prices, dev),
                           JAGConfig(degree=24, ls_build=48), device=dev)
    print("  degree stats:", index.degree_stats())

    # filtered queries: top-10 nearest with price in [lo, lo+50]
    b = 64
    q = rng.normal(size=(b, d)).astype(np.float32)
    lo = rng.uniform(0, 950, b).astype(np.float32)
    filt = range_filters(lo, lo + 50.0, dev)        # ~5% selectivity

    res = index.search(q, filt, k=10, ls=64)
    gt = exact_filtered_knn(index.xb, index.attr,
                            torch.as_tensor(q, device=dev), filt, k=10)
    rec = recall_at_k(res.ids.cpu().numpy(), res.primary.cpu().numpy() == 0,
                      gt.ids.cpu().numpy()).mean()
    print(f"recall@10 = {rec:.3f}  "
          f"(mean distance comps: {float(res.n_dist.float().mean()):.0f}"
          f" vs brute-force {float(gt.n_dist.float().mean()):.0f})")

    # persistence round-trip
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jag_quickstart.npz")
        index.save(path)
        idx2 = JAGIndex.load(path, device=dev)
    res2 = idx2.search(q, filt, k=10, ls=64)
    assert torch.equal(res.ids, res2.ids)
    print("save/load round-trip OK")


if __name__ == "__main__":
    main()
