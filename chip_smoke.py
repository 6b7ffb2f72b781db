#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of JAG (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--n N] [--degree R] [--ls-build L] [--batch-size B]
                          [--cand-pool C] [--out report.json]
                          [--profile trace.json]

Phases, in order; any failure ends the script with a non-zero exit and no
result line:

1. Device: CUDA with capability (9, 0); prints nvidia-smi's name and power
   limit.
2. Kernel build: nvcc compiles every kernel of ``src/repro_torch/csrc``
   (one process per source, all at once).
3. Kernels against their plain versions, at the shapes the main path gives
   them (slice A's data and its per-query plan): max errors, kernel time,
   plain-version time and a one-call PyTorch yardstick where there is one.
   d2 tolerance: |kernel - plain| <= 1e-5 * (|x|^2 + |q|^2), the magnitude
   of the terms the norm form sums (FP32 sum order differs); attr words,
   ids and popcounts are bit-exact.
4. Slice A, the main path at MSTuring's published width: msturing_subset
   (d = 100, 30 Bernoulli(1/2) subset attributes, N = 1,000,000),
   ``JAGIndex.build`` on the card (degree 128, ls_build 96, cand_pool
   192, batch 8192: at degree 96 or less the graph route's recall at
   ls = 64 stays under the bar at this N, PERF.md); every row's degree
   must be at least R / 8. Then 1024 queries through
   ``search_auto(k=10, ls=64, layout="fused")``; the req_ks mix (0..12
   required bits) spans the prefilter, graph and postfilter routes. Every
   kernel's launch count in that run must be above 0, and the graph-routed
   queries' recall@10 against the exact scan at least 0.80.
5. Slice B, the Boolean call site of the deficit kernel: msturing_bool
   (N = 100,000, 15 variables) through the prefilter scan on the card with
   the kernels, whose ids must equal the same scan's through the plain
   versions.

The last lines are nvidia-smi's card line, one JSON object with a record
per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM FP32 outside the tensor cores
DTOL = 1e-5                    # d2 tolerance, relative to |x|^2 + |q|^2
RECALL_MIN = 0.80
MIN_DEGREE_SHARE = 1 / 8       # a built row below R / 8 edges is a fault


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_d2(torch, name, got, want, scale):
    err = (got - want).abs()
    bad = err > DTOL * scale
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: d2 off by {float(err.max())} (> {DTOL} x scale) at "
            f"{int(bad.sum())} entries")
    return float(err.max())


def check_exact(torch, name, got, want):
    """Max |got - want| over integer tensors, which must be 0."""
    err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    if err != 0.0:
        n = int((got != want).sum())
        raise AssertionError(f"{name}: {n} entries differ from the plain "
                             f"version (max {err})")
    return err


def profile_main_path(torch, run, trace_path: str) -> dict:
    """Device busy share and the top kernels of one traced run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    Path(trace_path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(trace_path)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                   for us, k, c in rows[:12]]}
    log(f"[profile] wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%)")
    for r in out["top"]:
        log(f"[profile]   {r['device_ms']:9.3f} ms {r['calls']:6d}x "
            f"{r['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="slice A database rows")
    ap.add_argument("--batch-size", type=int, default=8192,
                    help="JAGConfig.batch_size of slice A's build")
    ap.add_argument("--degree", type=int, default=128,
                    help="JAGConfig.degree of slice A's build")
    ap.add_argument("--ls-build", type=int, default=96,
                    help="JAGConfig.ls_build of slice A's build")
    ap.add_argument("--cand-pool", type=int, default=192,
                    help="JAGConfig.cand_pool of slice A's build")
    ap.add_argument("--out", default=None,
                    help="also write the full report here as JSON")
    ap.add_argument("--profile", default=None,
                    help="also trace one main-path run with torch.profiler "
                         "and write its Chrome trace here (the device busy "
                         "share in PERF.md)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core.filters import pack_bits, onehot_words
    from repro_torch.core.ground_truth import exact_filtered_knn
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.core.recall import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.serve.layout import build_layout
    from repro_torch.serve.planner import PlannerConfig, plan_per_query

    report = {"args": vars(args)}
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    dev = resolve_device("cuda")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs an sm_90 card, found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} capability {cap} | nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    report["device"] = {"kind": kind, "nvidia_smi": smi}

    # -- 2. kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    t_build = time.perf_counter() - t0
    log(f"[build] {len(paths)} kernels in {t_build:.2f} s")
    for name, out in _build.PTXAS_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    report["kernel_build_s"] = t_build

    # -- 3. kernels against their plain versions ---------------------------
    N, D, NQ, K, LS = args.n, 100, 1024, 10, 64
    MI = 2 * LS                          # search_auto's default max_iters
    t0 = time.perf_counter()
    ds = synthetic.msturing_subset(n=N, d=D, b=NQ, device=dev)
    log(f"[data] msturing_subset N={N} d={D} queries={NQ} in "
        f"{time.perf_counter() - t0:.1f} s")
    xb = torch.as_tensor(ds.xb, device=dev)
    q_all = torch.as_tensor(ds.queries, device=dev)
    pq = plan_per_query(ds.filt, ds.attr, PlannerConfig())
    groups = {g.route: g.ids for g in pq.groups}
    log("[plan] " + " ".join(f"{r}:{len(i)}" for r, i in groups.items()))
    for r in ("prefilter", "graph", "postfilter"):
        if r not in groups:
            raise AssertionError(f"slice A's plan has no {r} queries")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels = {}

    # fused_expand: the graph group's expansion of C = R + EX neighbours
    # the overflow re-prune takes 2 rows per inserted point and batch, the
    # reference's 256 rows per batch of 128
    cfg = JAGConfig(degree=args.degree, ls_build=args.ls_build,
                    batch_size=args.batch_size, cand_pool=args.cand_pool,
                    ov_max=2 * args.batch_size)
    lay = build_layout(xb, ds.attr)
    gi = torch.as_tensor(groups["graph"], device=dev)
    Bg, C = len(gi), cfg.degree + cfg.ex_slots
    qg = q_all[gi].contiguous()
    qgn = torch.sum(qg * qg, dim=-1)
    ids = torch.randint(0, N, (Bg, C), generator=gen, device=dev,
                        dtype=torch.int32)
    kd2, kw = ops.fused_expand(lay.packed, ids, qg, qgn, d=D)
    pd2, pw = ref.fused_expand(lay.packed, ids, qg, qgn, d=D)
    scale = lay.packed[ids.long(), D] + qgn[:, None]
    err = check_d2(torch, "fused_expand", kd2, pd2, scale)
    check_exact(torch, "fused_expand words", kw.view(torch.int32),
                pw.contiguous().view(torch.int32))
    A = lay.n_attr_words
    b, o = bound_ms(Bg * C * ((D + 1 + A) * 4 + 4 + 4 + A * 4)
                    + Bg * (D + 1) * 4, 2 * Bg * C * D)
    kernels["fused_expand"] = dict(
        name="fused_expand", route="cuda",
        source="src/repro_torch/csrc/fused_expand.cu",
        replaces="src/repro/kernels/fused_expand.py:49",
        shape=f"packed[{N},{D + 1 + A}] ids[{Bg},{C}]", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.fused_expand(lay.packed, ids, qg, qgn,
                                                   d=D), 50),
        plain_ms=cuda_ms(torch, lambda: ref.fused_expand(
            lay.packed, ids, qg, qgn, d=D), 10),
        bound_ms=b, bound_by=o, library_ms=None)

    # gather_dist_tile: one block of the prefilter group's scan
    block = 4096
    pi = torch.as_tensor(groups["prefilter"], device=dev)
    Bp = len(pi)
    dp = D + (-D) % 8
    xpad = torch.nn.functional.pad(xb, (0, dp - D, 0, (-N) % block))
    qp = torch.nn.functional.pad(q_all[pi], (0, dp - D)).contiguous()
    base = torch.full((Bp,), (N // block) // 2, dtype=torch.int32,
                      device=dev)
    kt = ops.gather_dist_tile(xpad, base, qp, tile=block)
    pt = ref.gather_dist_tile(xpad, base, qp, tile=block)
    rows = xpad[int(base[0]) * block:(int(base[0]) + 1) * block]
    scale = (torch.sum(rows * rows, -1)[None, :]
             + torch.sum(qp * qp, -1)[:, None])
    err = check_d2(torch, "gather_dist_tile", kt, pt, scale)
    bit_exact = torch.equal(kt, pt)
    # lanes with differing bases take the per-lane path
    base2 = torch.randint(0, xpad.shape[0] // block, (64,), generator=gen,
                          device=dev, dtype=torch.int32)
    k2 = ops.gather_dist_tile(xpad, base2, qp[:64].contiguous(), tile=block)
    p2 = ref.gather_dist_tile(xpad, base2, qp[:64].contiguous(), tile=block)
    bit_exact &= torch.equal(k2, p2)
    log(f"[kernels] gather_dist_tile bit-exact with its plain version: "
        f"{bit_exact}")
    if not bit_exact:
        raise AssertionError("gather_dist_tile is not bit-exact")
    b, o = bound_ms((block * dp + Bp * dp + Bp + Bp * block) * 4,
                    2 * Bp * block * dp)
    x_tile = rows.contiguous()
    kernels["gather_dist_tile"] = dict(
        name="gather_dist_tile", route="cuda",
        source="src/repro_torch/csrc/gather_dist_tile.cu",
        replaces="src/repro/kernels/gather_dist.py:69",
        shape=f"xb[{xpad.shape[0]},{dp}] q[{Bp},{dp}] tile={block}",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.gather_dist_tile(xpad, base, qp,
                                                       tile=block), 50),
        plain_ms=cuda_ms(torch, lambda: ref.gather_dist_tile(
            xpad, base, qp, tile=block), 3),
        bound_ms=b, bound_by=o,
        library_ms=cuda_ms(torch, lambda: torch.mm(qp, x_tile.T), 50))

    # bitset_dist: subset validity of the prefilter group on one block
    fbits = ds.filt.data["bits"][pi].contiguous()
    abits = ds.attr.data["bits"][:block].contiguous()
    W = fbits.shape[1]
    err = max(check_exact(torch, f"bitset_dist[{op}]",
                          ops.bitset_dist(fbits, abits, op=op),
                          ref.bitset_dist(fbits, abits, op=op))
              for op in ("deficit", "xor"))
    b, o = bound_ms((Bp * W + block * W + Bp * block) * 4, Bp * block * W)
    kernels["bitset_dist"] = dict(
        name="bitset_dist", route="cuda",
        source="src/repro_torch/csrc/bitset_dist.cu",
        replaces="src/repro/kernels/bitset.py:38",
        shape=f"a[{Bp},{W}] b[{block},{W}] op=deficit", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.subset_deficit(fbits, abits), 50),
        plain_ms=cuda_ms(torch, lambda: ref.subset_deficit(fbits, abits),
                         10),
        bound_ms=b, bound_by=o, library_ms=None)
    # the Boolean call site's width: W = 2^15 / 32 = 1024 words
    satg = torch.rand((128, 1 << 15), generator=gen, device=dev) < 0.3
    sat_w = pack_bits(satg)
    hot = onehot_words(torch.randint(0, 1 << 15, (block,), generator=gen,
                                     device=dev), 1 << 15)
    check_exact(torch, "bitset_dist[deficit, W=1024]",
                ops.subset_deficit(sat_w, hot), ref.subset_deficit(sat_w, hot))
    bool_ms = cuda_ms(torch, lambda: ops.subset_deficit(sat_w, hot), 10)
    bb, bo = bound_ms((128 * 1024 + block * 1024 + 128 * block) * 4,
                      128 * block * 1024)
    log(f"[kernels] bitset_dist deficit a[128,1024] b[{block},1024]: "
        f"{bool_ms:.4f} ms (bound {bb:.4f} ms by {bo})")
    report["bitset_dist_boolean_width"] = dict(ms=bool_ms, bound_ms=bb,
                                               bound_by=bo)
    for kr in kernels.values():
        log(f"[kernels] {kr['name']} {kr['shape']}: max_abs_err "
            f"{kr['max_abs_err']:.3g}, {kr['ms']:.4f} ms (plain "
            f"{kr['plain_ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms by "
            f"{kr['bound_by']}, library {kr['library_ms']})")
    del lay, xpad, satg, hot
    torch.cuda.empty_cache()

    # -- 4. slice A: build + routed serving on the card --------------------
    log(f"[slice A] build N={N} d={D} degree={cfg.degree} "
        f"ls_build={cfg.ls_build} batch_size={cfg.batch_size} "
        f"cand_pool={cfg.cand_pool} ov_max={cfg.ov_max}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = JAGIndex.build(xb, ds.attr, cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    t_idx = time.perf_counter() - t0
    stats = idx.degree_stats()
    log(f"[slice A] build {t_idx:.1f} s, degree {stats}")
    report["slice_a"] = {"n": N, "d": D, "build_s": t_idx,
                         "batch_size": cfg.batch_size, "degree": stats}

    timings = {}

    def on_group(g, res, secs):
        timings[g.route] = (len(g.ids), secs)

    ops.reset_launches()
    res, p = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                             layout="fused", return_plan=True,
                             on_group=on_group)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"[slice A] launches in the main-path run: {launches}")
    for name, n_launch in launches.items():
        if n_launch <= 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
        kernels[name]["launches"] = n_launch
    cold = {r: (n, s) for r, (n, s) in timings.items()}
    timings.clear()
    res2 = idx.search_auto(q_all, ds.filt, k=K, ls=LS, max_iters=MI,
                           layout="fused", on_group=on_group)
    torch.cuda.synchronize()
    if not torch.equal(res.ids, res2.ids):
        raise AssertionError("two runs of the main path disagree")
    qps = {r: n / s for r, (n, s) in timings.items()}
    for r, (n, s) in timings.items():
        log(f"[slice A] {r}: {n} queries, {s * 1e3:.1f} ms, "
            f"{n / s:.1f} QPS (first run {cold[r][1] * 1e3:.1f} ms)")

    if args.profile:
        report["slice_a"]["profile"] = profile_main_path(
            torch, lambda: idx.search_auto(q_all, ds.filt, k=K, ls=LS,
                                           max_iters=MI, layout="fused"), args.profile)

    ids_np = res.ids.cpu().numpy()
    if ids_np.shape != (NQ, K):
        raise AssertionError(f"result shape {ids_np.shape}")
    if not bool(torch.isfinite(res.secondary[res.ids >= 0]).all()):
        raise AssertionError("non-finite distances in the result")
    gt = exact_filtered_knn(idx.xb, idx.attr, q_all, ds.filt, k=K,
                            use_kernel=True)
    # the oracle itself, on queries whose filter passes every row, against
    # one plain product over the whole database (near-ties may swap)
    allv = torch.nonzero(gt.n_dist == N).reshape(-1)[:128]
    if allv.numel() == 0:
        raise AssertionError("slice A has no query whose filter passes all")
    qa = q_all[allv]
    d2f = (idx.xb_norm[None, :] - 2.0 * (qa @ idx.xb.T)
           + torch.sum(qa * qa, -1)[:, None])
    top = torch.topk(d2f, K, largest=False).indices.cpu().numpy()
    del d2f
    g_ids = gt.ids[allv].cpu().numpy()
    agree = float(np.mean([len(set(a) & set(b)) / K
                           for a, b in zip(top, g_ids)]))
    log(f"[slice A] exact scan vs one plain product on {allv.numel()} "
        f"unfiltered queries: {agree:.4f} of the ids agree")
    if agree < 0.99:
        raise AssertionError(f"the exact scan disagrees with a plain product"
                             f" ({agree:.4f} of ids)")
    rec = recall_at_k(ids_np, res.primary.cpu().numpy() == 0.0,
                      gt.ids.cpu().numpy())
    recall = {r: float(rec[ids].mean()) for r, ids in groups.items()}
    log(f"[slice A] recall@{K} per route: {recall}")
    rg = rec[groups["graph"]]
    spread = {"zero": float((rg == 0).mean()), "below_half": float(
        (rg < 0.5).mean()), "full": float((rg == 1).mean())}
    log(f"[slice A] graph queries' recall: share at 0 {spread['zero']:.3f},"
        f" below 0.5 {spread['below_half']:.3f}, at 1 {spread['full']:.3f}")
    report["slice_a"]["graph_recall_spread"] = spread
    gsel = torch.as_tensor(groups["graph"], device=dev)
    n_exp = res.n_expanded[gsel]
    capped = float((n_exp >= MI).float().mean())
    log(f"[slice A] graph route: mean {float(n_exp.float().mean()):.1f} "
        f"expansions, {100 * capped:.1f}% of queries stopped at "
        f"max_iters = {MI}")
    report["slice_a"]["graph_expansions"] = {
        "mean": float(n_exp.float().mean()), "share_at_cap": capped}
    if not np.array_equal(ids_np[groups["prefilter"]],
                          gt.ids.cpu().numpy()[groups["prefilter"]]):
        raise AssertionError("prefilter route differs from the exact scan")
    if stats["min"] < cfg.degree * MIN_DEGREE_SHARE:
        raise AssertionError(f"the build left a row of degree {stats['min']}"
                             f" (< {cfg.degree} x {MIN_DEGREE_SHARE})")
    if recall["graph"] < RECALL_MIN:
        raise AssertionError(f"graph-route recall@{K} {recall['graph']:.4f}"
                             f" < {RECALL_MIN}")
    report["slice_a"].update(queries={r: len(i) for r, i in groups.items()},
                             qps=qps, recall=recall, launches=launches,
                             first_run_ms={r: s * 1e3
                                           for r, (_, s) in cold.items()})
    del idx, gt, res, res2
    torch.cuda.empty_cache()

    # -- 5. slice B: Boolean validity through the deficit kernel -----------
    t0 = time.perf_counter()
    dsb = synthetic.msturing_bool(n=100_000, d=D, b=128, n_vars=15,
                                  device=dev)
    xbb = torch.as_tensor(dsb.xb, device=dev)
    qb = torch.as_tensor(dsb.queries, device=dev)
    ops.reset_launches()
    got = exact_filtered_knn(xbb, dsb.attr, qb, dsb.filt, k=K,
                             use_kernel=True)
    torch.cuda.synchronize()
    lb = dict(ops.LAUNCHES)
    want = exact_filtered_knn(xbb, dsb.attr, qb, dsb.filt, k=K,
                              use_kernel=True, impl=ref)
    if lb["bitset_dist"] <= 0 or lb["gather_dist_tile"] <= 0:
        raise AssertionError(f"slice B skipped a kernel: {lb}")
    check_exact(torch, "slice B ids", got.ids, want.ids)
    check_exact(torch, "slice B n_dist", got.n_dist, want.n_dist)
    n_valid = int((got.ids >= 0).sum())
    log(f"[slice B] msturing_bool N=100000 prefilter scan: ids equal to the "
        f"plain scan ({n_valid} hits), launches {lb}, "
        f"{time.perf_counter() - t0:.1f} s")
    report["slice_b"] = {"launches": lb, "hits": n_valid}

    report["kernels"] = [kernels[n] for n in _build.SOURCES]
    report["total_s"] = time.perf_counter() - t_start
    log(f"[done] {report['total_s']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in report["kernels"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
