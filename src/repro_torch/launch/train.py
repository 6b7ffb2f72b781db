"""Fault-tolerant training launcher: ``--arch <id>`` + reduced/tiny configs
(counterpart of ``repro.launch.train``).

  * auto-resume from the latest committed checkpoint (crash = rerun cmd)
  * deterministic per-(seed, step) data order (restart-identical batches,
    ``data.pipelines.lm_batch``)
  * straggler monitoring: per-step wall time EWMA; steps slower than
    ``straggler_factor`` x EWMA are logged with their step index
  * metrics JSONL for the benchmark harness; ``--fail-at-step`` exits 42
    before that step (the crash-resume test).

Runs on the card by default (``--device cuda``); ``--device cpu`` runs it
here. Example (trains a ~100M-param qwen3-shaped model):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --scale tiny --steps 50 --ckpt-dir ck
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get
from ..data.pipelines import lm_batch
from ..device import resolve_device
from ..train import OptConfig, init_state, make_train_step


def tiny_lm(cfg):
    """~100M-param variant of an assigned LM arch (the reference's, without
    its ``kv_block``, which the port does not have)."""
    return dataclasses.replace(
        cfg, n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=0,
        d_ff=1536, vocab=8192, n_experts=min(cfg.n_experts, 4),
        attn_chunk=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "reduced"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="simulate a crash (fault-tolerance test)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = get(args.arch)
    assert spec.family == "lm", "train launcher: LM archs (GNN/recsys use " \
                                "their example scripts)"
    cfg = tiny_lm(spec.make_config()) if args.scale == "tiny" \
        else spec.make_reduced()
    # minicpm trains with WSD per its paper
    sched = "wsd" if args.arch == "minicpm-2b" else args.schedule
    opt_cfg = OptConfig(lr=args.lr, schedule=sched, warmup_steps=10,
                        total_steps=args.steps)
    dev = resolve_device(args.device)

    from ..models import transformer as T
    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    params.requires_grad_(True)
    opt = init_state(params)
    step_fn = make_train_step(lambda p, b: T.loss_fn(cfg, p, b), opt_cfg)

    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
    start = 0
    got = ckpt.restore_latest({"params": params, "opt": opt}, device=dev)
    if got[0] is not None:
        start, tree, meta = got
        params, opt = tree["params"], tree["opt"]
        print(f"[train] resumed from step {start}", flush=True)

    ewma = None
    metrics = None
    mfile = open(args.metrics_out, "a") if args.metrics_out else None
    for step in range(start, args.steps):
        if step == args.fail_at_step:
            print(f"[train] simulating crash at step {step}", flush=True)
            os._exit(42)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
            step, args.batch, args.seq, cfg.vocab, args.seed).items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])         # waits for the step
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma:
            print(f"[straggler] step {step}: {dt:.3f}s vs EWMA {ewma:.3f}s")
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if mfile:
            mfile.write(json.dumps({"step": step, "loss": loss,
                                    "dt": dt}) + "\n")
            mfile.flush()
        ckpt.maybe_save(step + 1, {"params": params, "opt": opt},
                        meta={"arch": args.arch})
    ckpt.maybe_save(args.steps, {"params": params, "opt": opt},
                    meta={"arch": args.arch}, force=True)
    if mfile:
        mfile.close()
    print("[train] done; final loss",
          float(metrics["loss"]) if metrics is not None else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
