"""Perf harness: named variants of the chosen cells and their rows
(counterpart of ``repro.launch.perf``, which lowers each variant against
the production mesh and reports the roofline terms).

  PYTHONPATH=src python -m repro_torch.launch.perf --cell jag_serve
  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen3_train
  PYTHONPATH=src python -m repro_torch.launch.perf --cell maverick_train
  PYTHONPATH=src python -m repro_torch.launch.perf --cell din_train

Here each variant runs for real on one card (``--device``, default
``cuda``), except maverick's, whose state needs expert parallelism over
many cards and which stays a dry-run row on meta:

* ``jag_serve``: the reference's five variants of ``serve_1b`` (bf16 rows
  with the bitmap dedup, int8, int8 + scan dedup, int8 with the row norm
  recomputed, int8 at row width 64) through ``core.distributed.
  make_serve_step``, over one shard at the published width (``n_local``
  2^22, d 128, row width 80, 8 seeds, ls 128, k 10, max_iters 192,
  query_chunk 128). The data is seeded random (vectors, their int8 codes
  and scale, a range attribute, uniform adjacency): there is no build, as
  the reference's rows are lowerings. Cut: S = 1 shard and ``--queries``
  queries (256) in place of 4096. Row: ms a step, QPS, and the share of
  the flops bound (model_flops at the bf16 peak, the reference's
  accounting, and at the FP32 rate of the CUDA cores that run it).
* ``qwen3_train``: v2 (``attn_scores_bf16``) and v3 (+ remat "dots") at
  qwen3-1.7b's published width and depth, ``train_4k`` cut to 4 x 4,096
  tokens as accum = 2 microbatches. Row: seconds a step, share of the
  ``lm_model_flops`` bound at the bf16 peak, peak memory, and the
  launches of the bf16-score kernel.
* ``maverick_train``: the same two variants as dry-run rows (meta):
  per-card state bytes and whether they fit, on both production meshes.
* ``din_train``: the reference's four variants at ``train_batch`` (65,536
  rows) on one card: float32 and bf16 tables are timed; the
  ``table_rows -> model`` rule variants shard nothing on one card, so
  they show in the accounting (per-card state on the (16, 16) mesh).

``--out`` writes the rows as JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from ..configs import make_cell
from ..configs.shapes import JAG_SHAPES
from . import roofline as RL
from .mesh import make_local_mesh, make_production_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_reset(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _timed(fn, dev: torch.device, steps: int) -> List[float]:
    """Host seconds of each of ``steps`` synchronised calls of ``fn``."""
    out = []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                    + s[len(s) // 2])


# ---------------------------------------------------------------------------
# JAG serve_1b variants
# ---------------------------------------------------------------------------

JAG_VARIANTS = (
    # tag, make_serve_step variant, dedup, stored rows, row width
    ("baseline(bf16,bitmap)", "f32", "bitmap", "bf16", None),
    ("v1:int8", "int8", "bitmap", "int8", None),
    ("v2:int8+scan-dedup", "int8", "scan", "int8", None),
    ("v3:int8+scan+reg-norm", "int8_reg", "scan", "int8", None),
    # serve-time adjacency truncated to R = 64 (the build's EX spare
    # columns are all -1 after finalize)
    ("v4:int8+scan+W64", "int8", "scan", "int8", 64),
)


def jag_serve_data(device, *, n_local: int, queries: int, seed: int = 0,
                   shape: Optional[dict] = None) -> dict:
    """One shard of ``serve_1b`` at ``n_local`` rows, seeded random: bf16
    vectors and their norms, int8 codes with a per-dim scale and the
    dequantized norms, a range attribute in [0, 1), uniform adjacency,
    entries, bf16 queries and range filters of width 0.1."""
    shp = dict(shape or JAG_SHAPES["serve_1b"])
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, W = shp["d"], shp["row_width"]
    xb = torch.randn((1, n_local, d), generator=g, device=dev).to(
        torch.bfloat16)
    x32 = xb[0].float()
    norm = torch.sum(x32 * x32, -1)[None]
    scale = x32.abs().amax(0).clamp_min(1e-12) / 127.0
    codes = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    deq = codes.float() * scale
    norm8 = torch.sum(deq * deq, -1)[None]
    del x32, deq
    lo = torch.rand((queries,), generator=g, device=dev) * 0.9
    return dict(
        graph=torch.randint(0, n_local, (1, n_local, W), generator=g,
                            device=dev, dtype=torch.int32),
        xb=xb, norm=norm, codes=codes[None], norm8=norm8, scale=scale,
        attr={"value": torch.rand((1, n_local), generator=g, device=dev)},
        entries=torch.randint(0, n_local, (1, shp["n_seeds"]), generator=g,
                              device=dev, dtype=torch.int32),
        queries=torch.randn((queries, d), generator=g, device=dev).to(
            torch.bfloat16),
        filt={"lo": lo, "hi": lo + 0.1}, shape=shp)


def jag_serve_variants(out: list, device="cuda", n_local: int = 1 << 22,
                       queries: int = 256, steps: int = 2, seed: int = 0,
                       data: Optional[dict] = None) -> list:
    """The five serve variants on one shard: a row each (tag, ms, qps,
    bound shares, a check of the results)."""
    from ..core.distributed import ShardedServeConfig, make_serve_step
    dev = torch.device(device)
    data = data or jag_serve_data(dev, n_local=n_local, queries=queries,
                                  seed=seed)
    shp = data["shape"]
    cfg = ShardedServeConfig(k=shp["k"], ls=shp["ls"],
                             max_iters=shp["max_iters"],
                             query_chunk=shp["query_chunk"])
    d = shp["d"]
    for tag, variant, dedup, rows, width in JAG_VARIANTS:
        step = make_serve_step([dev], cfg, "range", "range", variant=variant,
                               dedup=dedup)
        graph = data["graph"]
        if width:
            graph = graph[..., :width].contiguous()
        W = graph.shape[-1]
        args = ((graph, data["xb"], data["norm"]) if rows == "bf16"
                else (graph, data["codes"], data["norm8"]))
        args = args + (data["attr"], data["entries"], data["queries"],
                       data["filt"])
        if rows == "int8":
            args = args + (data["scale"],)
        ids, prim, sec = step(*args)             # warm-up, checked below
        secs = _timed(lambda: step(*args), dev, steps)
        B = data["queries"].shape[0]
        ok = _check_range_results(ids, prim, sec, data, B, shp["k"],
                                  graph.shape[1])
        t = _median(secs)
        mf = B * shp["max_iters"] * W * d * 2
        row = dict(cell="jag_serve", tag=tag, variant=variant, dedup=dedup,
                   rows=rows, row_width=W, n_local=graph.shape[1],
                   queries=B, ms=t * 1e3, qps=B / t, model_flops=mf,
                   bound_share_bf16=mf / RL.HW["bf16_flops"] / t,
                   bound_share_fp32=mf / RL.HW["fp32_flops"] / t,
                   results_ok=ok, seconds=secs)
        print(f"jag_serve/{tag:26s} {row['ms']:9.2f} ms/step "
              f"{row['qps']:10.1f} QPS share(bf16 peak) "
              f"{row['bound_share_bf16']:.3g} share(fp32) "
              f"{row['bound_share_fp32']:.3g} results_ok={ok}", flush=True)
        out.append(row)
    return out


def _check_range_results(ids, prim, sec, data, B, k, n_local) -> bool:
    """The serve step's results hold together: [B, k], ids in range or
    -1, finite keys where an id is returned, and every id returned at
    primary 0 passes its query's range filter."""
    if tuple(ids.shape) != (B, k):
        return False
    found = ids >= 0
    if bool(((ids < -1) | (ids >= n_local)).any()):
        return False
    if not bool(torch.isfinite(sec[found]).all()):
        return False
    v = data["attr"]["value"][0][ids.clamp_min(0).long()]
    inside = (v >= data["filt"]["lo"][:, None]) & (
        v <= data["filt"]["hi"][:, None])
    return bool((inside | ~(found & (prim == 0))).all())


# ---------------------------------------------------------------------------
# LM train variants
# ---------------------------------------------------------------------------

LM_VARIANTS = (("v2:attn_scores_bf16", dict(attn_scores_bf16=True)),
               ("v3:+remat_dots", dict(attn_scores_bf16=True,
                                       remat_policy="dots")))


def lm_train_variants(arch: str, out: list, device="cuda", batch: int = 4,
                      seq: Optional[int] = None, accum: int = 2,
                      steps: int = 2, seed: int = 0,
                      shrink: Optional[dict] = None,
                      check_plain: bool = False) -> list:
    """Each LM variant's training step on one card at the arch's
    published width: ``train_4k`` cut to ``batch`` sequences (of ``seq``
    tokens) as ``accum`` microbatches; one warm-up step, then ``steps``
    timed. A row: seconds a step, the share of the ``lm_model_flops``
    bound, peak memory, each kernel's launches a step and the losses.
    ``shrink`` replaces config fields besides the variant's knobs (a
    small model for a test on the CPU). ``check_plain`` also computes the
    first step's loss with the plain attention (``kernels.ref``, the same
    knobs and weights, no gradient) for the row's ``plain_loss``."""
    from ..kernels import ref
    from ..models import transformer as T
    from ..kernels import ops
    dev = torch.device(device)
    mesh = make_local_mesh(device=dev.type)
    over = {"batch": batch} if seq is None else {"batch": batch, "seq": seq}
    for tag, knobs in LM_VARIANTS:
        knobs = dict(knobs, **(shrink or {}))
        cell = make_cell(arch, "train_4k", mesh, device=dev, seed=seed,
                         shape_overrides=over, config_overrides=knobs,
                         accum=accum)
        params, opt, b = cell["args"]
        cfg, cfg_tokens = cell["cfg"], b["tokens"].shape
        losses = []
        plain = None
        if check_plain:
            with torch.no_grad():
                n = cfg_tokens[0] // accum
                plain = sum(float(T.loss_fn(cfg, params, {
                    "tokens": b["tokens"][i * n:(i + 1) * n]}, impl=ref)[0])
                    for i in range(accum)) / accum

        def one():
            _, _, m = cell["fn"](params, opt, b)
            losses.append(float(m["loss"]))
        before = dict(ops.LAUNCHES)
        one()                                      # warm-up
        launches = {n: c - before[n] for n, c in ops.LAUNCHES.items()
                    if c != before[n]}
        _peak_reset(dev)
        secs = _timed(one, dev, steps)
        t = _median(secs)
        flops = RL.lm_model_flops(cfg, cfg_tokens[0], cfg_tokens[1] - 1,
                                  "train")
        row = dict(cell=f"{arch}_train", tag=tag, batch=cfg_tokens[0],
                   seq=cfg_tokens[1] - 1, accum=accum, s_per_step=t,
                   tokens_per_s=cfg_tokens[0] * (cfg_tokens[1] - 1) / t,
                   bound_share=flops / RL.HW["bf16_flops"] / t,
                   peak_bytes=_peak(dev), launches_per_step=launches,
                   losses=losses, plain_loss=plain, seconds=secs,
                   finite=all(math.isfinite(x) for x in losses))
        print(f"{arch}/{tag:22s} {t:8.3f} s/step share "
              f"{row['bound_share']:.4f} peak "
              f"{(row['peak_bytes'] or 0) / 2**30:.2f} GiB launches "
              f"{launches} losses {[round(x, 4) for x in losses]}",
              flush=True)
        out.append(row)
        del cell, params, opt, b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def lm_dryrun_variants(arch: str, out: list) -> list:
    """The LM variants as dry-run rows on meta (``launch.dryrun``), on
    both production meshes."""
    from .dryrun import MESHES, run_cell
    for tag, knobs in LM_VARIANTS:
        for mesh_name in MESHES:
            row = run_cell(arch, "train_4k", mesh_name, verbose=False,
                           config_overrides=knobs, tag=tag)
            row.update(cell=f"{arch}_train", tag=tag)
            sb = row["state_bytes"]
            print(f"{arch}/{tag:22s} {mesh_name:6s} {row['status']} "
                  f"state/card {sb['total'] / 2**30:.2f} GiB (params "
                  f"{sb['params'] / 2**30:.2f}, opt {sb['opt'] / 2**30:.2f},"
                  f" args {sb['args'] / 2**30:.2f}) fits={row['fits']} "
                  f"compute bound {row['t_comp_s'] * 1e3:.2f} ms",
                  flush=True)
            out.append(row)
    return out


# ---------------------------------------------------------------------------
# DIN train variants
# ---------------------------------------------------------------------------

DIN_VARIANTS = (
    ("baseline(f32,rows@data*model)", None, None),
    ("v1:bf16_table", torch.bfloat16, None),
    ("v2:rows@model-only", None, {"table_rows": "model"}),
    ("v3:bf16+rows@model", torch.bfloat16, {"table_rows": "model"}),
)


def din_train_variants(out: list, device="cuda", steps: int = 3,
                       seed: int = 0, batch: Optional[int] = None,
                       shrink: Optional[dict] = None) -> list:
    """The four DIN variants at ``train_batch``: the two table dtypes
    timed on one card (one warm-up, ``steps`` timed AdamW steps), and
    every variant's per-card state on the (16, 16) mesh under its rules.
    ``batch`` and ``shrink`` (config fields) cut it for a test."""
    from .dryrun import state_bytes
    dev = torch.device(device)
    prod = make_production_mesh()
    local = make_local_mesh(device=dev.type)
    over = {"batch": batch} if batch else None
    timed: Dict[object, dict] = {}
    for tag, tdt, rules in DIN_VARIANTS:
        knobs = dict({"table_dtype": tdt} if tdt is not None else {},
                     **(shrink or {})) or None
        acct = make_cell("din", "train_batch", prod, rule_overrides=rules,
                         config_overrides=knobs, shape_overrides=over)
        sb = state_bytes(acct, prod)
        if tdt not in timed:
            cell = make_cell("din", "train_batch", local, device=dev,
                             seed=seed, config_overrides=knobs,
                             shape_overrides=over)
            params, opt, b = cell["args"]
            losses = []

            def one():
                _, _, m = cell["fn"](params, opt, b)
                losses.append(float(m["loss"]))
            one()
            _peak_reset(dev)
            secs = _timed(one, dev, steps)
            timed[tdt] = dict(s_per_step=_median(secs), seconds=secs,
                              losses=losses, peak_bytes=_peak(dev),
                              examples_per_s=b["label"].shape[0]
                              / _median(secs),
                              finite=all(math.isfinite(x) for x in losses)
                              and all(bool(torch.isfinite(p).all())
                                      for p in params.parameters()),
                              model_flops=cell["model_flops"])
            del cell, params, opt, b
        row = dict(cell="din_train", tag=tag, timed_as=str(tdt or "float32"),
                   state_bytes_16x16=sb, rule_overrides=rules,
                   **timed[tdt])
        print(f"din/{tag:30s} {row['s_per_step'] * 1e3:9.2f} ms/step "
              f"{row['examples_per_s']:12.1f} ex/s state/card(16x16) "
              f"{sb['total'] / 2**20:.1f} MiB (params "
              f"{sb['params'] / 2**20:.1f}) losses "
              f"{[round(x, 4) for x in row['losses']]}", flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="jag_serve",
                    choices=["jag_serve", "qwen3_train", "maverick_train",
                             "din_train"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", type=int, default=256,
                    help="jag_serve: queries a step (the cell's 4096, cut)")
    ap.add_argument("--n-local", type=int, default=1 << 22,
                    help="jag_serve: rows of the one shard")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device) if args.cell != "maverick_train" \
        else None
    rows: list = []
    if args.cell == "jag_serve":
        jag_serve_variants(rows, dev, n_local=args.n_local,
                           queries=args.queries)
    elif args.cell == "qwen3_train":
        lm_train_variants("qwen3-1.7b", rows, dev)
    elif args.cell == "din_train":
        din_train_variants(rows, dev)
    else:
        lm_dryrun_variants("llama4-maverick-400b-a17b", rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
