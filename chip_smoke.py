#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of JAG (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--n N] [--degree R] [--ls-build L] [--batch-size B]
                          [--cand-pool C] [--seed S] [--out report.json]
                          [--profile trace.json]

Phases, in order; any failure ends the script with a non-zero exit and no
result line:

1. Device: CUDA with capability (9, 0); prints nvidia-smi's name and power
   limit.
2. Kernel build: nvcc compiles every kernel of ``src/repro_torch/csrc``
   (one process per source, all at once).
3. Kernels against their plain versions, at the shapes the main path gives
   them (slice A's data and its per-query plan, slice C's prefill): max
   errors, kernel time, plain-version time and a one-call PyTorch
   yardstick where there is one. d2 tolerance: |kernel - plain| <= 1e-5 *
   (|x|^2 + |q|^2), the magnitude of the terms the norm form sums (FP32 sum
   order differs); attr words, ids and popcounts are bit-exact. Attention
   in bf16: |kernel - plain| <= 2^-7 |plain| + 1e-5, one bf16 rounding step
   (both round float32 values that differ in the sum order). gather_dist
   and l2dist have no caller on a path; they are held at slice A's graph
   shapes and at the prefilter scan's and kernels_bench's widths.
4. Slice A, the main path at MSTuring's published width: msturing_subset
   (d = 100, 30 Bernoulli(1/2) subset attributes, N = 1,000,000),
   ``JAGIndex.build`` on the card (degree 128, ls_build 96, cand_pool
   192, batch 8192: at degree 96 or less the graph route's recall at
   ls = 64 stays under the bar at this N, PERF.md); every row's degree
   must be at least R / 8. Then 1024 queries through
   ``search_auto(k=10, ls=64, layout="fused")``; the req_ks mix (0..12
   required bits) spans the prefilter, graph and postfilter routes. The
   launch count of each of the three kernels of this path in that run must
   be above 0, and the graph-routed queries' recall@10 against the exact
   scan at least 0.80.
5. Slice B, the Boolean call site of the deficit kernel: msturing_bool
   (N = 100,000, 15 variables) through the prefilter scan on the card with
   the kernels, whose ids must equal the same scan's through the plain
   versions.
6. Slice C, dense-LM serving: qwen3-1.7b at its published width and depth
   (28 layers, d_model 2048, 16 heads, 8 kv heads, head_dim 128, vocab
   151,936), random weights from ``--seed`` on the card, matrices kept in
   bf16 for serving. 4 requests of 4,096 prompt tokens (LM_SHAPES
   prefill_32k, batch 32 x 32,768, cut to 4 x 4,096 to fit the time
   limit): one ``prefill`` through the flash-attention kernel (exactly 28
   launches), then 32 greedy ``decode_step``s. Checks: in float32 (the
   masters, before the cast), the prefill's logits with the kernel against
   the plain attention within 1e-4 of the largest logit (float32 sum
   order). In bf16 the two differ by more: an attention output that moves
   by one bf16 step moves every later layer's roundings. The yardstick is
   bf16's own error, e = max |plain bf16 logits - plain float32 logits|:
   each bf16 prefill lies about e from the float32 one, so two of them lie
   up to 2e apart. The kernel's bf16 prefill must stay within 2e of the
   plain bf16 prefill, and the first decode step's logits within 2e of a
   prefill over T + 1 tokens.

The last lines are nvidia-smi's card line, one JSON object with a record
per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM FP32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
DTOL = 1e-5                    # d2 tolerance, relative to |x|^2 + |q|^2
RECALL_MIN = 0.80
MIN_DEGREE_SHARE = 1 / 8       # a built row below R / 8 edges is a fault
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 4096, 32   # prefill_32k cut to fit
LM_F32_TOL = 1e-4              # float32 prefill, of the largest logit
LM_BF16_NOISE = 2              # bf16 checks: widths of bf16's own error


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


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of slice C's random weights and prompts")
    ap.add_argument("--out", default=None,
                    help="also write the full report here as JSON")
    ap.add_argument("--profile", default=None,
                    help="also trace one main-path run of slice A and one "
                         "decode step of slice C with torch.profiler and "
                         "write their Chrome traces here and beside it "
                         "(.decode.json; the device busy shares in PERF.md)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.core.filters import pack_bits, onehot_words
    from repro_torch.core.ground_truth import exact_filtered_knn
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.core.recall import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import transformer as TT
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

    # gather_dist (no caller on a path): the graph group's expansion shapes
    kg = ops.gather_dist(xb, ids, qg)
    err = check_d2(torch, "gather_dist", kg, ref.gather_dist(xb, ids, qg),
                   scale)
    b, o = bound_ms(Bg * C * (D * 4 + 4 + 4) + Bg * D * 4, 3 * Bg * C * D)
    kernels["gather_dist"] = dict(
        name="gather_dist", route="cuda",
        source="src/repro_torch/csrc/gather_dist.cu",
        replaces="src/repro/kernels/gather_dist.py:34",
        shape=f"xb[{N},{D}] ids[{Bg},{C}]", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.gather_dist(xb, ids, qg), 50),
        plain_ms=cuda_ms(torch, lambda: ref.gather_dist(xb, ids, qg), 10),
        bound_ms=b, bound_by=o, library_ms=None)
    del kg

    # l2dist (no caller on a path): every query against a scan-sized slab
    # of slice A's rows, and kernels_bench's 256 x 8192 x 128
    xl = xb[:min(N, 262_144)]

    def check_l2(qq, xx):
        got, want = ops.l2dist(qq, xx), ref.l2dist(qq, xx)
        sc = torch.sum(qq * qq, -1)[:, None] + torch.sum(xx * xx, -1)[None]
        return check_d2(torch, f"l2dist {tuple(qq.shape)}x{tuple(xx.shape)}",
                        got, want, sc)

    err = check_l2(q_all, xl)
    b, o = bound_ms((NQ * D + len(xl) * D + NQ * len(xl)) * 4,
                    2 * NQ * len(xl) * D)
    kernels["l2dist"] = dict(
        name="l2dist", route="cuda", source="src/repro_torch/csrc/l2dist.cu",
        replaces="src/repro/kernels/l2dist.py:44",
        shape=f"q[{NQ},{D}] xb[{len(xl)},{D}]", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.l2dist(q_all, xl), 10),
        plain_ms=cuda_ms(torch, lambda: ref.l2dist(q_all, xl), 3),
        bound_ms=b, bound_by=o,
        library_ms=cuda_ms(torch, lambda: torch.mm(q_all, xl.T), 10))
    qb8 = torch.randn((256, 128), generator=gen, device=dev)
    xb8 = torch.randn((8192, 128), generator=gen, device=dev)
    bench = dict(max_abs_err=check_l2(qb8, xb8),
                 ms=cuda_ms(torch, lambda: ops.l2dist(qb8, xb8), 50),
                 library_ms=cuda_ms(torch, lambda: torch.mm(qb8, xb8.T), 50))
    bench["bound_ms"], bench["bound_by"] = bound_ms(
        (256 * 128 + 8192 * 128 + 256 * 8192) * 4, 2 * 256 * 8192 * 128)
    log(f"[kernels] l2dist q[256,128] xb[8192,128] (kernels_bench): "
        f"{bench['ms']:.4f} ms (bound {bench['bound_ms']:.4f} ms by "
        f"{bench['bound_by']}, torch.mm {bench['library_ms']:.4f} ms)")
    report["l2dist_kernels_bench"] = bench
    del xl, qb8, xb8
    torch.cuda.empty_cache()

    # flash_attention: one layer of slice C's prefill
    lm = configs.get(LM_ARCH).CONFIG
    fshape = (LM_BATCH, lm.n_heads, LM_PROMPT, lm.hd)
    kshape = (LM_BATCH, lm.n_kv_heads, LM_PROMPT, lm.hd)
    fq, fk, fv = (torch.randn(sh, generator=gen, device=dev).to(lm.dtype)
                  for sh in (fshape, kshape, kshape))
    fo = ops.flash_attention(fq, fk, fv).float()
    fp = ref.flash_attention(fq, fk, fv).float()
    ferr = (fo - fp).abs()
    bad = ferr > 2.0 ** -7 * fp.abs() + 1e-5
    if bool(bad.any()):
        raise AssertionError(f"flash_attention: {int(bad.sum())} outputs off"
                             f" by more than a bf16 step (max "
                             f"{float(ferr.max())})")
    n_el = 2 * fq.numel() + 2 * fk.numel()         # q, k, v and out
    b, o = bound_ms(n_el * fq.element_size(),
                    2 * LM_BATCH * lm.n_heads * LM_PROMPT ** 2 * lm.hd,
                    BF16_OPS_PER_S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attn.py:66",
        shape=f"q[{','.join(map(str, fshape))}] "
              f"kv[{','.join(map(str, kshape))}] bf16 causal",
        max_abs_err=float(ferr.max()),
        ms=cuda_ms(torch, lambda: ops.flash_attention(fq, fk, fv), 5),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention(fq, fk, fv), 2,
                         warmup=1),
        bound_ms=b, bound_by=o,
        library_ms=cuda_ms(torch, lambda: sdpa(fq, fk, fv, is_causal=True,
                                               enable_gqa=True), 10))
    del fq, fk, fv, fo, fp, ferr, bad
    torch.cuda.empty_cache()

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
    for name in ("fused_expand", "gather_dist_tile", "bitset_dist"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never ran on the main path")
    for name, n_launch in launches.items():   # gather_dist, l2dist: on
        if name != "flash_attention":         # no path, their 0 is kept
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

    # -- 6. slice C: dense-LM serving ------------------------------------
    del xbb, qb, got, want
    torch.cuda.empty_cache()
    full = LM_SHAPES["prefill_32k"]
    log(f"[slice C] {lm.name}: {lm.n_layers} layers, d_model {lm.d_model}, "
        f"{lm.n_heads} heads, {lm.n_kv_heads} kv heads, head_dim {lm.hd}, "
        f"d_ff {lm.d_ff}, vocab {lm.vocab}, {lm.param_count()} params, "
        f"seed {args.seed}")
    log(f"[slice C] shape cut: LM_SHAPES['prefill_32k'] batch "
        f"{full['batch']} x {full['seq']} -> {LM_BATCH} x {LM_PROMPT} to fit "
        f"the script's time limit; then {LM_STEPS} greedy decode steps")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = TT.init_params(lm, gen, dev)
    toks = torch.randint(0, lm.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                         device=dev)

    def biggest(t):
        return float(t.float().abs().max())

    # float32: the kernel against the plain attention, sum order only
    lm32 = dataclasses.replace(lm, dtype=torch.float32)
    c32 = TT.init_cache(lm32, LM_BATCH, LM_PROMPT, dev)
    l32, _ = TT.prefill(lm32, params, toks, c32)
    l32p, _ = TT.prefill(lm32, params, toks, c32, impl=ref)
    del c32
    err32 = biggest(l32 - l32p)
    log(f"[slice C] float32 prefill, kernel vs plain attention: max |d| "
        f"{err32:.3g} of largest logit {biggest(l32p):.4g}")
    if err32 > LM_F32_TOL * biggest(l32p):
        raise AssertionError("float32 prefill: the kernel moves the logits "
                             f"by {err32} (> {LM_F32_TOL} of the largest)")

    # bf16 serving: matrices stored in bf16 (the float32 masters go)
    TT.cast_matrices(params, lm.dtype)
    torch.cuda.empty_cache()
    cache = TT.init_cache(lm, LM_BATCH, LM_PROMPT + LM_STEPS, dev)
    log(f"[slice C] set-up {time.perf_counter() - t0:.1f} s (init, float32 "
        f"check, cast)")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = TT.prefill(lm, params, toks, cache)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    lc = dict(ops.LAUNCHES)
    log(f"[slice C] launches in the prefill: {lc}")
    if lc["flash_attention"] != lm.n_layers:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{lc['flash_attention']} times, not "
                             f"{lm.n_layers}")
    kernels["flash_attention"]["launches"] = lc["flash_attention"]
    lp, _ = TT.prefill(lm, params, toks, cache, impl=ref)
    # bf16's own error: the plain bf16 prefill against float32
    noise = biggest(lp.float() - l32p)
    tol = LM_BF16_NOISE * noise
    err = biggest(logits - lp)
    log(f"[slice C] bf16 prefill, kernel vs plain attention: max |d| "
        f"{err:.4g} (limit {tol:.4g}: {LM_BF16_NOISE} x bf16 vs float32, "
        f"{noise:.4g})")
    if err > tol:
        raise AssertionError(f"bf16 prefill: the kernel moves the logits by "
                             f"{err} (> {tol})")

    # serving alone from here: one prefill, then the decode steps; the
    # peak covers these and nothing of the checks above
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = TT.prefill(lm, params, toks, cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    if tuple(logits.shape) != (LM_BATCH, lm.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are not "
                             "finite or not [B, V]")

    def decode(i, nxt):
        pos = torch.full((LM_BATCH,), LM_PROMPT + i, dtype=torch.int32,
                         device=dev)
        dl, _ = TT.decode_step(lm, params, cache, nxt, pos)
        return dl, dl[:, :lm.vocab].argmax(-1)

    first = logits[:, :lm.vocab].argmax(-1)
    t0 = time.perf_counter()
    d0, nxt = decode(0, first)
    torch.cuda.synchronize()
    t_step0 = time.perf_counter() - t0
    # steps 2..LM_STEPS: one window, synchronised only at its two ends;
    # events between the steps give each step's interval for the median
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(LM_STEPS)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(1, LM_STEPS):
        dl, nxt = decode(i, nxt)
        marks[i].record()
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    t_decode = t_window / (LM_STEPS - 1)
    if args.profile:
        pos = torch.full((LM_BATCH,), LM_PROMPT + LM_STEPS - 1,
                         dtype=torch.int32, device=dev)
        report["slice_c_decode_profile"] = profile_main_path(
            torch, lambda: TT.decode_step(lm, params, cache, nxt, pos),
            str(Path(args.profile).with_suffix(".decode.json")))
    if not bool(torch.isfinite(dl).all()):
        raise AssertionError("decode logits are not finite")
    del cache
    toks1 = torch.cat([toks, first[:, None]], dim=1)
    l1, _ = TT.prefill(lm, params, toks1,
                       TT.init_cache(lm, LM_BATCH, LM_PROMPT + 1, dev))
    derr = biggest(d0 - l1)
    log(f"[slice C] decode at position {LM_PROMPT} vs a prefill over "
        f"{LM_PROMPT + 1} tokens: max |d| {derr:.4g} (limit {tol:.4g})")
    if derr > tol:
        raise AssertionError(f"decode disagrees with prefill by {derr} "
                             f"(> {tol})")
    n_tok = LM_BATCH * LM_PROMPT
    log(f"[slice C] prefill {n_tok} tokens in {t_prefill * 1e3:.1f} ms: "
        f"{n_tok / t_prefill:.1f} tokens/s (first run {t_first * 1e3:.1f} "
        f"ms); decode {t_decode * 1e3:.3f} ms per step of {LM_BATCH} "
        f"tokens (steps 2-{LM_STEPS} in one window; median step "
        f"{float(np.median(step_ms)):.3f} ms, the first step took "
        f"{t_step0 * 1e3:.1f} ms); peak memory of the prefill and decode "
        f"{peak / 2 ** 30:.2f} GiB")
    report["slice_c"] = dict(
        arch=lm.name, batch=LM_BATCH, prompt=LM_PROMPT, steps=LM_STEPS,
        prefill_s=t_prefill, prefill_first_s=t_first,
        prefill_tokens_per_s=n_tok / t_prefill, decode_ms_per_step=t_decode
        * 1e3, decode_median_ms=float(np.median(step_ms)),
        decode_first_ms=t_step0 * 1e3, decode_step_ms=step_ms, peak_bytes=peak,
        launches=lc, f32_err=err32, bf16_err=err, bf16_vs_f32=noise,
        decode_vs_prefill=derr)
    del params, logits, lp, l32, l32p, l1
    torch.cuda.empty_cache()

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
