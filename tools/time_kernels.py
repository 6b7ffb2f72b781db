#!/usr/bin/env python3
"""Time the port's kernels on one H100: flash_attention (bf16 and
float32), gather_dist_tile, fused_expand, gather_dist, bitset_dist and
l2dist.

    python3 tools/time_kernels.py [--src DIR] [--lanes B [B ...]]
                                  [--widths W [W ...]]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so one command can time two checkouts on the same card in turns (parent,
change, change, parent). Shapes are those of ``chip_smoke.py``:
flash_attention on bf16 q [4, 16, 4096, 128], k/v [4, 8, 4096, 128],
causal (one layer of slice C's prefill), beside
``scaled_dot_product_attention``; gather_dist_tile on q [568, 104] against
one tile of 4096 rows (a block of slice A's prefilter scan), beside one
``torch.mm`` of the same product; ``--lanes`` times it at other query
batch widths as well, which separates its fixed cost from its cost per
lane. Each kernel is first held against its plain version with
chip_smoke's own checks: flash_attention must pass its bf16 gate and
gather_dist_tile its d2 tolerance; whether gather_dist_tile is also
bit-exact, as chip_smoke requires, is printed with its times, so that a
variant of the source that gives up the contract can be timed too.

fused_expand runs at slice A's graph shape, packed [1000000, 102] (d =
100, one attr word) and ids [315, 144], with cold rows (chip_smoke's
COLD_SETS id batches in turn, more rows than the L2 holds) and warm (one
batch); bitset_dist (deficit) at the prefilter scan's subset shape, a
[568, 1] against b [4096, 1], and at the Boolean width, a [128, 1024]
against one-hot b [4096, 1024]; ``--widths`` adds a [568, W] against b
[4096, W] for each W given. Both are held exactly (bitset_dist) or within
DTOL with bitwise words (fused_expand) against their plain versions first.
Beside them stand PyTorch yardsticks of the same bytes, which the port
does not call: for fused_expand an ``index_select`` of the same rows and
a copy of as many contiguous rows, both cold; for bitset_dist a
``fill_`` of an output of the same size.
The float32 attention kernel (``flash_attention_f32``, split-TF32) runs
on the same shapes in float32, beside SDPA in float32, within chip_smoke's
float32 gate. Its error is also measured on inputs drawn in float32 (the
timed ones are bf16 values, whose lo halves are 0) against the same
attention evaluated in float64, beside the plain version's: the largest
and mean |error| and the share of the error that points toward zero,
sum(-sign(exact) * error) / sum(|error|), which is near 0 where every
rounding is to nearest and near 1 where they truncate. The same timing
and float64 comparison run at head_dim 256 (q [1, 16, 2048, 256], k/v [1,
8, 2048, 256], drawn in float32, causal), the mma.sync kernel. l2dist on
q [1024, 100] against xb [262144, 100] drawn in float32 (every query of
slice A against a scan-sized slab), beside one ``torch.mm`` of the same
product with TF32 off, within DTOL (its largest error's share of the limit
is printed with its times), and against float64 beside the plain version
(``chip_smoke.l2dist_vs_f64``: the same three figures, and the share of
the error that moves q.x toward zero).
gather_dist runs on xb [1000000, 100] f32 with the fused_expand id batches
(ids [315, 144]), cold (the batches in turn) and warm, beside a cold
``index_select`` of the same rows as the bytes yardstick (not the same
function).
Prints ptxas's register and spill lines of the libraries it built,
nvidia-smi's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (COLD_SETS, check_bitset,  # noqa: E402
                        check_d2, check_flash, check_fused_expand,
                        check_l2dist, check_scan_tile, cold_ms, cuda_ms,
                        error_stats, ptxas_report)

ITERS = 20


def attention_f64(torch, q, k, v):
    """Causal GQA softmax attention in float64, one batch row at a time."""
    G, T = q.shape[1] // k.shape[1], q.shape[2]
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    out = []
    for b in range(q.shape[0]):
        s = (q[b].double() / math.sqrt(q.shape[-1])) @ \
            k[b].double().repeat_interleave(G, 0).transpose(-1, -2)
        out.append(torch.softmax(s.masked_fill(~mask, -math.inf), -1)
                   @ v[b].double().repeat_interleave(G, 0))
        del s
    return torch.stack(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--lanes", type=int, nargs="+", default=[568],
                    help="gather_dist_tile query batch widths")
    ap.add_argument("--widths", type=int, nargs="*", default=[],
                    help="more bitset_dist word counts W, at a [568, W] "
                         "against b [4096, W]")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core.filters import onehot_words, pack_bits
    from repro_torch.kernels import _build, ops, ref
    _build.build_all()
    for name, out in _build.PTXAS_LOG.items():
        for fn, regs, spill in ptxas_report(out):
            print(f"[build] {name}: {fn}: {regs} registers, {spill} bytes "
                  "of spill stores")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"src": args.src}

    qs, ks = (4, 16, 4096, 128), (4, 8, 4096, 128)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in (qs, ks, ks))
    check_flash(torch, ops, ref, q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["flash_attention"] = dict(
        ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v), ITERS),
        sdpa_ms=cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                            enable_gqa=True), ITERS))
    q, k, v = (t.float() for t in (q, k, v))
    check_flash(torch, ops, ref, q, k, v)
    res["flash_attention_f32"] = dict(
        ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v), 5),
        sdpa_ms=cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                            enable_gqa=True), 5))
    g32 = torch.Generator(device=dev)      # leaves gen's draws as they were
    g32.manual_seed(1)
    q, k, v = (torch.randn(s, generator=g32, device=dev) for s in (qs, ks, ks))
    exact = attention_f64(torch, q, k, v)
    res["flash_attention_f32"]["vs_f64"] = dict(
        kernel=error_stats(torch, ops.flash_attention(q, k, v), exact),
        plain=error_stats(torch, ref.flash_attention(q, k, v), exact))
    del q, k, v, exact
    # head_dim 256: the mma.sync kernel
    q, k, v = (torch.randn(s, generator=g32, device=dev)
               for s in ((1, 16, 2048, 256), (1, 8, 2048, 256),
                         (1, 8, 2048, 256)))
    check_flash(torch, ops, ref, q, k, v)
    exact = attention_f64(torch, q, k, v)
    res["flash_attention_f32_d256"] = dict(
        ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v), ITERS),
        vs_f64=dict(
            kernel=error_stats(torch, ops.flash_attention(q, k, v), exact),
            plain=error_stats(torch, ref.flash_attention(q, k, v), exact)))
    del q, k, v, exact

    q = torch.randn((1024, 100), generator=gen, device=dev)
    x = torch.randn((262144, 100), generator=gen, device=dev)
    _, share, f64 = check_l2dist(torch, ops, ref, q, x)
    res["l2dist"] = dict(
        err_share=share, vs_f64=f64,
        ms=cuda_ms(torch, lambda: ops.l2dist(q, x), 10 * ITERS // 4),
        mm_ms=cuda_ms(torch, lambda: torch.mm(q, x.T), 10 * ITERS // 4))
    del q, x
    torch.cuda.empty_cache()

    tile, dp = 4096, 104
    xb = torch.randn((8 * tile, dp), generator=gen, device=dev)
    x_tile = xb[3 * tile:4 * tile].contiguous()
    res["gather_dist_tile"] = {}
    for B in args.lanes:
        qp = torch.randn((B, dp), generator=gen, device=dev)
        base = torch.full((B,), 3, dtype=torch.int32, device=dev)
        _, exact = check_scan_tile(torch, ops, ref, xb, base, qp, tile)
        res["gather_dist_tile"][B] = dict(
            bit_exact=exact,
            ms=cuda_ms(torch, lambda: ops.gather_dist_tile(xb, base, qp,
                                                           tile=tile),
                       10 * ITERS),
            mm_ms=cuda_ms(torch, lambda: torch.mm(qp, x_tile.T),
                          10 * ITERS))
    del xb, x_tile, qp

    n, d, B, C = 1_000_000, 100, 315, 144
    x = torch.randn((n, d), generator=gen, device=dev)
    attr = torch.randint(0, 2 ** 30, (n, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    packed = torch.cat([x, (x * x).sum(-1, keepdim=True),
                        attr.view(torch.float32)], dim=1)
    del attr
    q = torch.randn((B, d), generator=gen, device=dev)
    qn = (q * q).sum(-1)
    id_sets = [torch.randint(0, n, (B, C), generator=gen, device=dev,
                             dtype=torch.int32) for _ in range(COLD_SETS)]
    check_fused_expand(torch, ops, ref, packed, id_sets[0], q, qn, d)
    # yardsticks, cold as well: one PyTorch gather of the same rows, and a
    # copy of as many contiguous rows (the same bytes, read in order)
    flat = [s.reshape(-1).long() for s in id_sets]
    slabs = [packed[i * B * C:(i + 1) * B * C] for i in range(COLD_SETS)]
    slab_out = torch.empty_like(slabs[0])
    res["fused_expand"] = dict(
        cold_ms=cold_ms(torch, [lambda s=s: ops.fused_expand(packed, s, q, qn,
                                                             d=d)
                                for s in id_sets], 10 * ITERS),
        warm_ms=cuda_ms(torch, lambda: ops.fused_expand(packed, id_sets[0], q,
                                                        qn, d=d), 10 * ITERS),
        index_select_cold_ms=cold_ms(
            torch, [lambda s=s: torch.index_select(packed, 0, s)
                    for s in flat], 10 * ITERS),
        contiguous_copy_cold_ms=cold_ms(
            torch, [lambda s=s: slab_out.copy_(s) for s in slabs],
            10 * ITERS))
    del packed, slabs, slab_out
    # gather_dist on the same rows without the norm and attr word
    rows = x[id_sets[0].long()]
    check_d2(torch, "gather_dist", ops.gather_dist(x, id_sets[0], q),
             ref.gather_dist(x, id_sets[0], q),
             (rows * rows).sum(-1) + qn[:, None])
    res["gather_dist"] = dict(
        cold_ms=cold_ms(torch, [lambda s=s: ops.gather_dist(x, s, q)
                                for s in id_sets], 10 * ITERS),
        warm_ms=cuda_ms(torch, lambda: ops.gather_dist(x, id_sets[0], q),
                        10 * ITERS),
        index_select_cold_ms=cold_ms(
            torch, [lambda s=s: torch.index_select(x, 0, s) for s in flat],
            10 * ITERS))
    del x, rows, id_sets, flat

    def words(shape):
        return torch.randint(0, 2 ** 32, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    cases = {"a[568,1] b[4096,1]": (words((568, 1)), words((4096, 1)))}
    sat = pack_bits(torch.rand((128, 1 << 15), generator=gen, device=dev)
                    < 0.3)
    hot = onehot_words(torch.randint(0, 1 << 15, (4096,), generator=gen,
                                     device=dev), 1 << 15)
    cases["a[128,1024] b[4096,1024]"] = (sat, hot)
    for w in args.widths:
        cases[f"a[568,{w}] b[4096,{w}]"] = (words((568, w)),
                                            words((4096, w)))
    res["bitset_dist"] = {}
    for label, (a, b) in cases.items():
        check_bitset(torch, ops, ref, a, b)
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                          device=dev)
        res["bitset_dist"][label] = dict(
            ms=cuda_ms(torch, lambda: ops.subset_deficit(a, b), 10 * ITERS),
            # yardstick: one PyTorch write of the same output bytes
            fill_ms=cuda_ms(torch, lambda: out.fill_(0), 10 * ITERS))

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
