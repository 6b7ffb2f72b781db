"""End-to-end serving driver on the port (the paper's workload;
counterpart of ``examples/filtered_search_e2e.py``, on ``repro_torch``):
build a JAG over a mixed-selectivity dataset, serve batched filtered
queries of all four filter types, report recall/QPS against exact ground
truth — plus the post-filtering baseline and the selectivity-adaptive
planner (``search_auto``, which routes each query to prefilter | graph |
postfilter — a mixed batch prints as route "mixed") for contrast.

  PYTHONPATH=src python examples/torch_filtered_search_e2e.py [--n 8000] \
      [--device cuda]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import JAGConfig, JAGIndex
from repro_torch.core import baselines as BL
from repro_torch.core.ground_truth import exact_filtered_knn
from repro_torch.core.recall import recall_at_k
from repro_torch.data import synthetic as SYN
from repro_torch.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(name, make_ds, cfg, dev, ls=64):
    ds = make_ds()
    t0 = time.time()
    index = JAGIndex.build(ds.xb, ds.attr, cfg, device=dev)
    _sync(dev)
    build_s = time.time() - t0
    unf = BL.build_unfiltered(ds.xb, ds.attr, cfg, device=dev)
    gt = exact_filtered_knn(index.xb, ds.attr,
                            torch.as_tensor(ds.queries, device=dev), ds.filt,
                            k=10)

    plans = []

    def run_auto():
        res, p = index.search_auto(ds.queries, ds.filt, k=10, ls=ls,
                                   return_plan=True)
        plans.append(p)          # the route the measured call actually took
        return res

    out = {}
    for algo, run in (
            ("jag", lambda: index.search(ds.queries, ds.filt, k=10, ls=ls)),
            ("auto", run_auto),
            ("post", lambda: BL.post_filter_search(unf, ds.queries,
                                                   ds.filt, k=10, ls=ls))):
        run()
        _sync(dev)
        t0 = time.perf_counter()
        res = run()
        _sync(dev)
        dt = time.perf_counter() - t0
        rec = recall_at_k(res.ids.cpu().numpy(),
                          res.primary.cpu().numpy() == 0,
                          gt.ids.cpu().numpy()).mean()
        out[algo] = (rec, len(ds.queries) / dt)
    print(f"{name:18s} build={build_s:5.0f}s  "
          f"JAG recall={out['jag'][0]:.3f} qps={out['jag'][1]:7.0f}   "
          f"auto[{plans[-1].route}] recall={out['auto'][0]:.3f} "
          f"qps={out['auto'][1]:7.0f}   "
          f"post recall={out['post'][0]:.3f} qps={out['post'][1]:7.0f}  "
          f"(mean selectivity {np.mean(ds.selectivity):.3f})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    n = args.n
    cfg = JAGConfig(degree=24, ls_build=48, batch_size=256, cand_pool=96)
    serve("range (Fig.1)", lambda: SYN.msturing_range(n=n, b=128,
                                                      device=dev), cfg, dev)
    serve("label (Fig.3)", lambda: SYN.sift_like(n=n, b=128, device=dev),
          cfg, dev)
    serve("subset (Fig.4)", lambda: SYN.msturing_subset(n=n, b=128,
                                                        device=dev), cfg, dev)
    serve("boolean (Fig.5)", lambda: SYN.msturing_bool(n=n, b=64,
                                                       device=dev), cfg, dev)


if __name__ == "__main__":
    main()
