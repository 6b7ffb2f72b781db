"""The bf16-score variant on the H100: its gate and where its time goes.

    PYTHONPATH=src python tools/flash_bf16.py [--part gate|ablation|both]
                                              [--shape B H Hkv T D]

``gate``: ``flash_attention_bf16`` with each knob (``scores_bf16``,
``p_bf16``) against its plain version through ``chip_smoke``'s
``bf16_variant_gate`` (the largest excess over one bf16 step and the
share of outputs past one step), at the gpu test's shapes and slice C's
prefill shape (two seeds at T = 4,096), beside the split kernel
(``flash_attention``, knobs ignored) against the same knobbed plain
version, which the gate must refuse.

``ablation``: times the variant's score mode with each of the steps that
mode adds to the split kernel taken out of a copy of
``csrc/flash_attention.cu``, beside the unchanged variant, its p_bf16
mode and the split kernel, at ``--shape`` (slice C's prefill shape).
Each ablation edits a copy of the sources in a temporary directory,
builds it with the package's nvcc flags and stands in for the library of
``flash_attention`` while it is timed. An ablated kernel computes wrong
values: only its time is read.

* ``q_mul``: the Q rescale multiplies by bf16(sqrt D) where it divided
  (``__fdiv_rn``), so the pass stays and the division goes;
* ``no_q_pass``: no Q rescale pass in shared memory, nor its barrier;
* ``no_s_round``: S is not rounded to bf16;
* ``no_p_round``: p = 2^((s - bf16(m)) log2 e), without rounding s - m or
  p to bf16;
* ``no_rounds``: ``no_q_pass``, ``no_s_round`` and ``no_p_round``
  together.

Prints nvidia-smi's name and power limit, a line per gate case, ptxas's
registers and spill stores of each build, the ms of each version
(``chip_smoke.cuda_ms``, 20 calls, every version timed in the order
given and again reversed) and one JSON line of both parts.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (bf16_variant_gate, cuda_ms,  # noqa: E402
                        gate_line, ptxas_report)

ITERS = 20
Q_PASS = ("    if constexpr (kMode == kBf16S) {\n"
          "      // Q of this warpgroup's 64 rows")
S_ROUND = "        for (int i = 0; i < kBK / 2; ++i) sc[i] = bf16r(sc[i]);\n"
P_ROUND = "x = isfinite(x) ? bf16r(ex2(bf16r(x - mb) * kLog2e)) : 0.0f;"
Q_DIV = ("__fdiv_rn(f.x, q_div),\n"
         "                                       __fdiv_rn(f.y, q_div)")
EDITS = {
    "q_mul": [(Q_DIV, "f.x * q_div, f.y * q_div")],
    "no_q_pass": [(Q_PASS, Q_PASS.replace("kMode == kBf16S", "false"))],
    "no_s_round": [(S_ROUND, "")],
    "no_p_round": [(P_ROUND,
                    "x = isfinite(x) ? ex2((x - mb) * kLog2e) : 0.0f;")],
}
EDITS["no_rounds"] = (EDITS["no_q_pass"] + EDITS["no_s_round"]
                      + EDITS["no_p_round"])


def build_ablations(_build, tmp: Path) -> dict:
    """Each ablation's library, built in parallel from edited copies."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r} once")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(tmp / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        for fn, regs, spill in ptxas_report(out):
            if "<128," in fn:
                print(f"[build] {name}: {fn}: {regs} registers, {spill} "
                      "bytes of spill stores")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for src_name, fn_name, argtypes in _build.SIGNATURES.values():
            if src_name == "flash_attention":
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


GATE_SHAPES = ((1, 2, 1, 40, 64), (2, 4, 2, 300, 128), (1, 2, 2, 200, 256),
               (1, 3, 1, 129, 32), (2, 16, 8, 1024, 128),
               (4, 16, 8, 4096, 128))


def gate_cases(torch, ops, ref, dev) -> list:
    """``bf16_variant_gate`` of the variant and of the split kernel
    against the knobbed plain version, a row per shape, seed and knob."""
    rows = []
    g = torch.Generator(device=dev)
    for B, H, Hkv, T, D in GATE_SHAPES:
        for seed in ((0, 1) if T >= 4096 else (0,)):
            g.manual_seed(1000 * seed + D + T)
            q = torch.randn((B, H, T, D), generator=g, device=dev).bfloat16()
            k, v = (torch.randn((B, Hkv, T, D), generator=g,
                                device=dev).bfloat16() for _ in range(2))
            split = ops.flash_attention(q, k, v)
            for knob in ("scores_bf16", "p_bf16"):
                flags = {knob: True}
                want = ref.flash_attention(q, k, v, **flags)
                got = ops.flash_attention(q, k, v, **flags)
                row = dict(shape=[B, H, Hkv, T, D], seed=seed, knob=knob,
                           variant=bf16_variant_gate(torch, got, want),
                           split=bf16_variant_gate(torch, split, want))
                print(f"[gate] {row['shape']} seed {seed} {knob}: variant "
                      f"{gate_line(row['variant'])}; split "
                      f"{gate_line(row['split'])}", flush=True)
                rows.append(row)
            del q, k, v, split
            torch.cuda.empty_cache()
    return rows


def ablation(torch, ops, _build, dev, shape) -> dict:
    """ms of the split kernel, the variant's two modes and each ablation
    of its score mode at ``shape``."""
    for fn, regs, spill in ptxas_report(_build.PTXAS_LOG.get(
            "flash_attention", "")):
        if "<128," in fn:
            print(f"[build] as is: {fn}: {regs} registers, {spill} bytes "
                  "of spill stores")
    B, H, Hkv, T, D = shape
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, T, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, Hkv, T, D), generator=g, device=dev).bfloat16()
            for _ in range(2))
    tmp = Path(tempfile.mkdtemp(prefix="flash_bf16_ablation_"))
    base = _build.library("flash_attention")
    try:
        libs = build_ablations(_build, tmp)
        runs = [("split", base, {}), ("p_bf16", base, {"p_bf16": True}),
                ("scores_bf16", base, {"scores_bf16": True})]
        runs += [(name, lib, {"scores_bf16": True})
                 for name, lib in libs.items()]
        times = {name: [] for name, _, _ in runs}
        for order in (runs, runs[::-1]):
            for name, lib, flags in order:
                _build._LIBS["flash_attention"] = lib
                times[name].append(cuda_ms(
                    torch, lambda: ops.flash_attention(q, k, v, **flags),
                    ITERS))
    finally:
        _build._LIBS["flash_attention"] = base
        shutil.rmtree(tmp, ignore_errors=True)
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in times.items():
        each = ", ".join(f"{x:.6f}" for x in t)
        print(f"{name:12s} {ms[name]:.6f} ms ({each}; "
              f"{ms[name] / ms['split']:.3f}x the split kernel)")
    return dict(shape=list(shape), ms=ms, runs=times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("gate", "ablation", "both"),
                    default="both")
    ap.add_argument("--shape", type=int, nargs=5, default=[4, 16, 8, 4096,
                                                           128],
                    metavar=("B", "H", "Hkv", "T", "D"))
    args = ap.parse_args(argv)
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = resolve_device("cuda")
    _build.library("flash_attention")
    out = {}
    if args.part in ("gate", "both"):
        out["gate"] = gate_cases(torch, ops, ref, dev)
    if args.part in ("ablation", "both"):
        out["ablation"] = ablation(torch, ops, _build, dev, args.shape)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
