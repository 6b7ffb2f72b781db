"""The paper's technique inside the recsys serving path (retrieval_cand),
on the port (counterpart of ``examples/recsys_retrieval_jag.py``, on
``repro_torch``):

candidate generation for a two-stage recommender = *filtered* nearest
neighbor search over item embeddings (filter = item category / price band),
served from a JAG index instead of brute-force scanning 10^6 candidates;
the DeepFM tower then scores the survivors.

  PYTHONPATH=src python examples/torch_recsys_retrieval_jag.py \
      [--n 20000] [--device cuda]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (JAGConfig, JAGIndex, label_filters,
                              label_table)
from repro_torch.core.ground_truth import exact_filtered_knn
from repro_torch.core.recall import recall_at_k
from repro_torch.device import resolve_device
from repro_torch.models import recsys as R


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n_items, d = args.n, 16
    n_cats = 20

    # item tower embeddings + a category attribute per item
    items = rng.normal(size=(n_items, d)).astype(np.float32)
    cats = rng.integers(0, n_cats, n_items)

    print(f"building JAG over {n_items} item embeddings "
          f"(label attribute = category)...")
    t0 = time.time()
    index = JAGIndex.build(items, label_table(cats, dev),
                           JAGConfig(degree=24, ls_build=48, batch_size=512),
                           device=dev)
    _sync(dev)
    print(f"  built in {time.time() - t0:.0f}s")

    # user queries restricted to one category (the filter)
    b = 64
    users = rng.normal(size=(b, d)).astype(np.float32)
    want = rng.integers(0, n_cats, b)
    filt = label_filters(want, dev)

    # stage 1a: JAG filtered candidate generation
    index.search(users, filt, k=50, ls=128)
    _sync(dev)
    t0 = time.perf_counter()
    res = index.search(users, filt, k=50, ls=128)
    _sync(dev)
    jag_dt = time.perf_counter() - t0

    # stage 1b: brute-force reference (what retrieval_cand does w/o JAG)
    t0 = time.perf_counter()
    gt = exact_filtered_knn(index.xb, index.attr,
                            torch.as_tensor(users, device=dev), filt, k=50)
    _sync(dev)
    bf_dt = time.perf_counter() - t0

    rec = recall_at_k(res.ids.cpu().numpy(), res.primary.cpu().numpy() == 0,
                      gt.ids.cpu().numpy()).mean()
    print(f"candidate recall@50 = {rec:.3f}; "
          f"JAG {b / jag_dt:.0f} qps vs brute-force {b / bf_dt:.0f} qps "
          f"({bf_dt / jag_dt:.1f}x)")

    # stage 2: score survivors with a (reduced) DeepFM tower
    cfg = R.RecsysConfig(kind="deepfm", n_sparse=4, embed_dim=8,
                         total_vocab=4096, mlp_dims=(32, 16), n_dense=4)
    params = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    cand = np.maximum(res.ids.cpu().numpy(), 0)
    batch = {"sparse_ids": rng.integers(0, 64, (b * 50, 4)).astype(np.int32),
             "dense": rng.normal(size=(b * 50, 4)).astype(np.float32),
             "label": np.zeros(b * 50, np.float32)}
    with torch.no_grad():
        scores = R.forward(cfg, params, batch)
    scores = scores.cpu().numpy().reshape(b, 50)
    best = np.take_along_axis(cand, np.argmax(scores, 1)[:, None], 1)
    print(f"stage-2 ranked; example user 0 -> item {int(best[0, 0])} "
          f"(category {cats[best[0, 0]]}, wanted {want[0]})")


if __name__ == "__main__":
    main()
