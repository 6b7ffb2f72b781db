"""The bf16-score variant on the H100: its gate and where its time goes.

    PYTHONPATH=src python tools/flash_bf16.py [--part gate|ablation|both]
                                              [--shape B H Hkv T D]

``gate``: first the packed subtraction that the score mode uses for
s - bf16(m_safe) (``sub.rn.bf16x2``, ``tools/bf16_sub_check.cu``) against
the plain version's float32 difference rounded to bf16, over all 2^32
ordered pairs of finite bf16 values in both halves of the register: it
prints the count of mismatches, which must be 0. Then
``flash_attention_bf16`` with each knob (``scores_bf16``, ``p_bf16``)
against its plain version through ``chip_smoke``'s
``bf16_variant_gate`` (the largest excess over one bf16 step and the
share of outputs past one step), at the gpu test's cases (q times 30,
non-causal Tq > Tk among them) and slice C's prefill shape (two seeds at
T = 4,096), beside the split kernel (``flash_attention``, knobs ignored)
against the same knobbed plain version, which the gate must refuse.

``ablation``: times the variant with one of its steps taken out of a copy
of ``csrc/flash_attention.cu``, beside the unchanged variant in both
modes and the split kernel, at ``--shape`` (slice C's prefill shape).
Each ablation edits a copy of the sources in a temporary directory,
builds it with the package's nvcc flags and stands in for the library of
``flash_attention`` while it is timed. An ablated kernel computes wrong
values: only its time is read.

* ``turns``: not an ablation but FA3's ping-pong, which the kernel leaves
  out: the two consumer warpgroups take turns to issue their products
  (both modes);
* ``no_unroll``: the kv loop one tile an iteration (both modes);
* ``no_q_pass``: no Q rescale pass in shared memory, nor its barrier;
* ``no_sum``: l does not sum p (no widening of p, no adds);
* ``no_ex2``: p = bf16(x log2 e), without the SFU's 2^x;
* ``no_softmax``: no softmax at all: P.V takes a stale p, so what is
  left is the products, the ring of stages, O's rescale and p's hand-over
  (both modes);
* ``floor``: ``no_softmax`` and ``no_q_pass`` together.

Prints nvidia-smi's name and power limit, the mismatch count, a line per
gate case, ptxas's registers and spill stores of each build's D = 128
instances, the ms of each version (``chip_smoke.cuda_ms``, 20 calls,
every version timed in the order given and again reversed) and one JSON
line of both parts. Exits 1 if the count is not 0, the variant fails a
gate case or the split kernel passes one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (bf16_variant_gate, cuda_ms,  # noqa: E402
                        gate_line, ptxas_report)

ITERS = 20
SUB_CHECK = Path(__file__).resolve().with_name("bf16_sub_check.cu")
UNROLL = ("    // two tiles an iteration (faster than one: see the top of the "
          "file)\n#pragma unroll 2\n")
Q_PASS = ("    if constexpr (kMode == kBf16S) {\n"
          "      // Q of this warpgroup's 64 rows")
SUM = ("            if (i % 2) sum_b += bf16_lo(p) + bf16_hi(p);\n"
       "            else sum_a += bf16_lo(p) + bf16_hi(p);\n")
EX2 = ("            const uint32_t p = pack_bf16x2(ex2(bf16_lo(d) * kLog2e),\n"
       "                                           ex2(bf16_hi(d) * kLog2e));")
SOFTMAX_0 = "    softmax(0);\n    rescale_and_take();"
SOFTMAX_KT = ("      softmax(kt);\n"
              "      wg_wait<0>();          // so is tile kt-1's P.V\n"
              "      pin(o);\n      pin(pv);")
# FA3's ping-pong, which the kernel leaves out: the two consumer
# warpgroups take turns to issue their products (named barriers 3 + wg),
# warpgroup 0 first
BUFFERS = "    uint32_t pk[kBK / 16][4], pv[kBK / 16][4];\n"
TURN_FNS = """
    auto turn_wait = [&]() {
      if constexpr (kWG > 1)
        asm volatile("bar.sync %0, 256;\\n" :: "r"(3 + wg) : "memory");
    };
    auto turn_pass = [&]() {
      if constexpr (kWG > 1)
        asm volatile("bar.arrive %0, 256;\\n" :: "r"(4 - wg) : "memory");
    };
"""
FIRST = ("    mbar_wait(full_bar(bars, 0), 0);\n    wg_fence();\n"
         "    issue_scores<kD>(sc, q_wg, kv_s);\n")
LOOP = ("      wg_fence();\n"
        "      issue_scores<kD>(sc, q_wg, kv_s + s * L::kStageBytes);\n"
        "      issue_values(prev);\n")
LAST = ("    wg_fence();\n    issue_values((n_kt - 1) % kStages);\n"
        "    wg_wait<0>();\n    pin(o);\n    pin(pv);\n")
EDITS = {
    "turns": [(BUFFERS, BUFFERS + TURN_FNS),
              (FIRST, "    if (wg == 1) turn_pass();\n"
               + FIRST.replace("    wg_fence();\n",
                               "    turn_wait();\n    wg_fence();\n")
               + "    turn_pass();\n"),
              (LOOP, "      turn_wait();\n" + LOOP + "      turn_pass();\n"),
              (LAST, "    turn_wait();\n" + LAST.replace(
                  "    wg_wait<0>();\n",
                  "    if (wg == 0) turn_pass();\n    wg_wait<0>();\n"))],
    "no_unroll": [(UNROLL, "")],
    "no_q_pass": [(Q_PASS, Q_PASS.replace("kMode == kBf16S", "false"))],
    "no_sum": [(SUM, "")],
    "no_ex2": [(EX2, EX2.replace("ex2(", "("))],
    "no_softmax": [(SOFTMAX_0, "    rescale_and_take();"),
                   (SOFTMAX_KT, SOFTMAX_KT.replace("      softmax(kt);\n",
                                                   ""))],
}
EDITS["floor"] = EDITS["no_softmax"] + EDITS["no_q_pass"]
# the ablations timed in the p_bf16 mode too
BOTH_MODES = ("turns", "no_unroll", "no_softmax")


def nvcc_lib(_build, src: Path, out: Path, includes=()) -> subprocess.Popen:
    """Start nvcc on ``src`` with the package's flags."""
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
           *[f"-I{d}" for d in includes], "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def sub_check(torch, _build, dev) -> dict:
    """Mismatches of ``sub.rn.bf16x2`` against the float32 difference
    rounded to bf16, over every ordered pair of finite bf16 values."""
    tmp = Path(tempfile.mkdtemp(prefix="bf16_sub_check_"))
    try:
        proc = nvcc_lib(_build, SUB_CHECK, tmp / "check.so", [_build.CSRC])
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {SUB_CHECK.name}:\n{out}")
        fn = ctypes.CDLL(str(tmp / "check.so")).bf16_sub_check
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        first = torch.zeros(17, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = fn(counts.data_ptr(), first.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if err:
            raise RuntimeError(f"bf16_sub_check: CUDA error {err}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n, bad = (int(x) for x in counts.tolist())
    found = [int(x) & 0xFFFFFFFF for x in first.tolist()]
    examples = [dict(a=f"{found[i] >> 16:#06x}", b=f"{found[i] & 0xFFFF:#06x}",
                     half=found[8 + i]) for i in range(min(8, found[16]))]
    print(f"[sub] sub.rn.bf16x2 against the float32 difference rounded to "
          f"bf16: {bad} mismatches in {n} lane results (all ordered pairs "
          f"of finite bf16 values, both halves), {secs * 1e3:.1f} ms"
          + (f"; first: {examples}" if examples else ""), flush=True)
    return dict(lane_results=n, mismatches=bad, seconds=secs,
                examples=examples)


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
        procs[name] = nvcc_lib(_build, cu, tmp / f"{name}.so")
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        for fn, regs, spill in ptxas_report(out):
            if "<128" in fn:
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


# (B, H, Hkv, Tq, Tk, D, causal, q scale): the gpu test's cases, then
# slice C's prefill shape
GATE_CASES = ((1, 2, 1, 40, 40, 64, True, 1.0),
              (2, 4, 2, 300, 300, 128, True, 1.0),
              (1, 2, 2, 200, 200, 256, True, 1.0),
              (1, 3, 1, 129, 129, 32, True, 1.0),
              (1, 2, 1, 70, 200, 128, False, 1.0),
              (2, 16, 8, 1024, 1024, 128, True, 1.0),
              (2, 4, 2, 300, 300, 128, True, 30.0),
              (1, 2, 1, 200, 70, 128, False, 1.0),
              (4, 16, 8, 4096, 4096, 128, True, 1.0))


def gate_cases(torch, ops, ref, dev) -> list:
    """``bf16_variant_gate`` of the variant and of the split kernel
    against the knobbed plain version, a row per case, seed and knob."""
    rows = []
    g = torch.Generator(device=dev)
    for B, H, Hkv, Tq, Tk, D, causal, scale in GATE_CASES:
        for seed in ((0, 1) if Tq >= 4096 else (0,)):
            g.manual_seed(1000 * seed + D + Tq)
            q = (torch.randn((B, H, Tq, D), generator=g, device=dev)
                 * scale).bfloat16()
            k, v = (torch.randn((B, Hkv, Tk, D), generator=g,
                                device=dev).bfloat16() for _ in range(2))
            split = ops.flash_attention(q, k, v, causal=causal)
            for knob in ("scores_bf16", "p_bf16"):
                flags = dict(causal=causal, **{knob: True})
                want = ref.flash_attention(q, k, v, **flags)
                got = ops.flash_attention(q, k, v, **flags)
                row = dict(case=[B, H, Hkv, Tq, Tk, D, causal, scale],
                           seed=seed, knob=knob,
                           variant=bf16_variant_gate(torch, got, want),
                           split=bf16_variant_gate(torch, split, want))
                print(f"[gate] {row['case']} seed {seed} {knob}: variant "
                      f"{gate_line(row['variant'])}; split "
                      f"{gate_line(row['split'])}", flush=True)
                rows.append(row)
            del q, k, v, split
            torch.cuda.empty_cache()
    return rows


def ablation(torch, ops, _build, dev, shape) -> dict:
    """ms of the split kernel, the variant's two modes and each ablation
    at ``shape``."""
    for fn, regs, spill in ptxas_report(_build.PTXAS_LOG.get(
            "flash_attention", "")):
        if "<128" in fn:
            print(f"[build] as is: {fn}: {regs} registers, {spill} bytes "
                  "of spill stores")
    B, H, Hkv, T, D = shape
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, T, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, Hkv, T, D), generator=g, device=dev).bfloat16()
            for _ in range(2))
    tmp = Path(tempfile.mkdtemp(prefix="flash_bf16_ablation_"))
    base = _build.library("flash_attention")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        libs = build_ablations(_build, tmp)
        runs = [("split", base, {}), ("p_bf16", base, {"p_bf16": True}),
                ("scores_bf16", base, {"scores_bf16": True})]
        for name, lib in libs.items():
            runs.append((name, lib, {"scores_bf16": True}))
            if name in BOTH_MODES:
                runs.append((f"{name} p_bf16", lib, {"p_bf16": True}))
        times = {name: [] for name, _, _ in runs}
        times["sdpa"] = []
        for order in (runs, runs[::-1]):
            for name, lib, flags in order:
                _build._LIBS["flash_attention"] = lib
                times[name].append(cuda_ms(
                    torch, lambda: ops.flash_attention(q, k, v, **flags),
                    ITERS))
            times["sdpa"].append(cuda_ms(
                torch, lambda: sdpa(q, k, v, is_causal=True,
                                    enable_gqa=True), ITERS))
    finally:
        _build._LIBS["flash_attention"] = base
        shutil.rmtree(tmp, ignore_errors=True)
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in times.items():
        each = ", ".join(f"{x:.6f}" for x in t)
        print(f"{name:20s} {ms[name]:.6f} ms ({each}; "
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
        out["sub"] = sub_check(torch, _build, dev)
        out["gate"] = gate_cases(torch, ops, ref, dev)
    if args.part in ("ablation", "both"):
        out["ablation"] = ablation(torch, ops, _build, dev, args.shape)
    print(json.dumps(out))
    ok = (out.get("sub", {}).get("mismatches", 0) == 0
          and all(r["variant"]["ok"] and not r["split"]["ok"]
                  for r in out.get("gate", ())))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
