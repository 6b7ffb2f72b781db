"""Dry run of every (arch x shape x mesh) cell on the meta device
(counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell against 512 fake CPU devices).

Usage (no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh multi                            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results.json

Per cell and production mesh ((16, 16) "single", (2, 16, 16) "multi"):

* ``make_cell`` on the meta device, then the step run once on its meta
  tensors at full size: every op checks its shapes and dtypes and nothing
  is allocated. The run does not depend on the mesh (one eager process
  shards nothing), so a cell runs once and both meshes' rows report it.
  Steps that read a value on the host (the JAG serve step's early stop,
  the build) cannot run on meta: those cells are ``analytic_only`` and the
  row prints the reason.
* ``n_params``, ``model_flops`` and the compute bound ``model_flops /
  (cards x the bf16 peak)`` (``launch.roofline``); the memory term reads
  the per-card state once.
* The per-card state bytes: parameters, optimizer state and the other
  arguments, each tensor at its ``shard_shape`` under the rules; an
  argument the step updates in place is its own output, so it counts
  once. ``fits`` holds the state against a card's memory (``launch.mesh``:
  the card's ``total_memory``, else the data sheet's 80 GB): state only,
  since the reference's temporaries (XLA's ``memory_analysis``) have no
  meta counterpart.

Exit code 1 if any cell failed, as the reference's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import all_archs, make_cell
from ..distributed.sharding import shard_shape, use_rules
from ..train.optimizer import AdamWState
from . import roofline as RL
from .mesh import card_hbm_bytes, make_production_mesh

MESHES = ("single", "multi")

# (arch, shape, variant tag) -> (seconds, error or None) of its meta run in
# this process
_META_RUNS: Dict[Tuple[str, str, str], Tuple[float, object]] = {}


def leaves(arg, spec, prefix: str = ""):
    """(name, tensor, resolved spec) of every tensor of one argument and
    its spec tree: a module's parameters, an ``AdamWState``, dicts."""
    if isinstance(arg, nn.Module):
        named = dict(arg.named_parameters())
        return [(prefix + n, named[n], spec[n]) for n in named]
    if isinstance(arg, AdamWState):
        return ([(prefix + "step", arg.step, spec.step)]
                + leaves(arg.m, spec.m, prefix + "m.")
                + leaves(arg.v, spec.v, prefix + "v."))
    if isinstance(arg, dict):
        out = []
        for k, v in arg.items():
            out += leaves(v, spec[k], f"{prefix}{k}.")
        return out
    return [(prefix.rstrip(".") or "arg", arg, spec)]


def state_bytes(cell, mesh) -> Dict[str, float]:
    """Bytes a card holds of the cell's arguments, each tensor at its
    shard shape: ``params`` (argument 0 when it is a module), ``opt`` (an
    ``AdamWState``) and ``args`` (the rest), and their ``total``."""
    out = {"params": 0.0, "opt": 0.0, "args": 0.0}
    for i, (arg, spec) in enumerate(zip(cell["args"], cell["specs"])):
        key = ("params" if isinstance(arg, nn.Module)
               else "opt" if isinstance(arg, AdamWState) else "args")
        for _, t, sp in leaves(arg, spec, f"{i}."):
            n = 1
            for s in shard_shape(t.shape, sp, mesh):
                n *= s
            out[key] += n * t.element_size()
    out["total"] = out["params"] + out["opt"] + out["args"]
    return out


def meta_run(arch: str, shape: str, cell, tag: str = ""
             ) -> Tuple[float, object]:
    """Run the cell's step once on its meta tensors (once a process per
    cell and variant ``tag``): (seconds, the exception or None)."""
    key = (arch, shape, tag)
    if key not in _META_RUNS:
        t0 = time.perf_counter()
        err = None
        try:
            with use_rules(cell["rules"]):
                cell["fn"](*cell["args"])
        except Exception as e:          # reported by the cell's row
            err = e
        _META_RUNS[key] = (time.perf_counter() - t0, err)
    return _META_RUNS[key]


def run_cell(arch: str, shape: str, mesh_name: str, verbose: bool = True,
             config_overrides: Optional[dict] = None, tag: str = "") -> dict:
    """One cell's row (of a variant ``tag`` with ``config_overrides``, the
    perf harness's); raises if its step fails on meta."""
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    n_cards = mesh.size
    t0 = time.perf_counter()
    cell = make_cell(arch, shape, mesh, config_overrides=config_overrides)
    if cell["analytic_only"]:
        run_s, status = 0.0, "analytic_only"
    else:
        run_s, err = meta_run(arch, shape, cell, tag)
        if err is not None:
            raise RuntimeError(f"{arch} x {shape}: the step failed on meta: "
                               f"{type(err).__name__}: {err}") from err
        status = "ok"
    sb = state_bytes(cell, mesh)
    hbm, hbm_src = card_hbm_bytes()
    r = RL.analyze(f"{arch} x {shape} x {mesh_name}", n_bytes=sb["total"],
                   n_ops=cell["model_flops"] / n_cards,
                   rate=RL.HW["bf16_flops"])
    row = dict(arch=arch, shape=shape, mesh=mesh_name, n_cards=n_cards,
               status=status, reason=cell["reason"],
               n_params=cell["n_params"], model_flops=cell["model_flops"],
               flops_scale=cell["flops_scale"],
               t_comp_s=r.t_comp, t_mem_s=r.t_mem, bound_s=r.bound_s,
               state_bytes=sb, hbm_bytes=hbm, hbm_source=hbm_src,
               fits=sb["total"] <= hbm, meta_run_s=run_s,
               cell_s=time.perf_counter() - t0, roofline=r.to_dict())
    if verbose:
        print(f"[{arch} x {shape} x {mesh_name}] {status} "
              f"params={cell['n_params'] / 1e9:.3f}B meta run "
              f"{run_s:.2f}s", flush=True)
        if cell["reason"]:
            print(f"  analytic only: {cell['reason']}")
        print(f"  state/card: params={sb['params'] / 2**30:.3f}GiB "
              f"opt={sb['opt'] / 2**30:.3f}GiB args={sb['args'] / 2**30:.3f}"
              f"GiB total={sb['total'] / 2**30:.3f}GiB (card "
              f"{hbm / 2**30:.1f}GiB, {hbm_src}; state only) "
              f"fits={row['fits']}")
        print("  " + RL.format_row(r), flush=True)
    return row


def default_cells():
    cells = []
    for aid, spec in sorted(all_archs().items()):
        for shape in spec.shapes:
            cells.append((aid, shape))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-jag", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    cells = default_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if args.skip_jag:
        cells = [c for c in cells if c[0] != "jag"]
    meshes = MESHES if args.mesh == "both" else (args.mesh,)

    results, failures = [], []
    for aid, shape in cells:
        for mesh_name in meshes:
            try:
                results.append(run_cell(aid, shape, mesh_name))
            except Exception as e:
                traceback.print_exc()
                failures.append(
                    {"arch": aid, "shape": shape, "mesh": mesh_name,
                     "error": f"{type(e).__name__}: {e}"})
            if args.out:
                with open(args.out, "w") as f:
                    json.dump({"results": results, "failures": failures},
                              f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_an = sum(r["status"] == "analytic_only" for r in results)
    print(f"\n=== dry-run complete: {n_ok} ok, {n_an} analytic only, "
          f"{len(failures)} failed ===")
    for f_ in failures:
        print("  FAILED:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
