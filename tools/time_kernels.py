#!/usr/bin/env python3
"""Time the port's flash_attention and gather_dist_tile kernels on one H100.

    python3 tools/time_kernels.py [--src DIR] [--lanes B [B ...]]

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
variant of the source that gives up the contract can be timed too. Prints
nvidia-smi's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (check_flash, check_scan_tile,  # noqa: E402
                        cuda_ms)

ITERS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--lanes", type=int, nargs="+", default=[568],
                    help="gather_dist_tile query batch widths")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build, ops, ref
    _build.build_all()
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
    del q, k, v

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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
