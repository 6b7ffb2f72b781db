"""Work formulas and the table of peaks of the benchmark.

``kernel_work`` is a frozen copy of the port's
``repro_torch.launch.roofline.kernel_work`` for the two scan kernels
(``gather_dist_tile``, ``bitset_dist``); ``tests/test_jagbench_parts.py``
holds it equal to the original at the cells' shapes. A kernel's bound is
the larger of its bytes over the memory rate and its operations over the
peak rate of the pipe that runs them, against the published peaks of one
NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit).
"""
from __future__ import annotations

from typing import Tuple

PEAKS = dict(
    hbm_bw=3.35e12,            # bytes/s, HBM3
    fp32_flops=67e12,          # FP32 outside the tensor cores
    sms=132,                   # streaming multiprocessors, H100 SXM
    popc_per_clock=16,         # popcounts a clock an SM, compute capability
                               # 9.0 (CUDA C++ Programming Guide, throughput
                               # of native arithmetic instructions)
    max_sm_clock_mhz=1980,     # the data sheet's boost clock
)
POPC_RATE = (PEAKS["sms"] * PEAKS["popc_per_clock"]
             * PEAKS["max_sm_clock_mhz"] * 1e6)


def kernel_work(name: str, **shape) -> Tuple[float, float, float]:
    """(bytes, operations, operations a second) of one call of kernel
    ``name`` at ``shape``:

    gather_dist_tile(B, tile, dp)   one tile of ``tile`` rows per lane
    bitset_dist(B, N, W, popc_rate) popcounts at the card's popcount rate

    Bytes count each input row read once and each output written once.
    Operations count multiplies and adds (2 a product term).
    """
    s = shape
    if name == "gather_dist_tile":
        B, tile, dp = s["B"], s["tile"], s["dp"]
        return ((tile * dp + B * dp + B + B * tile) * 4, 2 * B * tile * dp,
                PEAKS["fp32_flops"])
    if name == "bitset_dist":
        B, N, W = s["B"], s["N"], s["W"]
        return (B * W + N * W + B * N) * 4, B * N * W, s["popc_rate"]
    raise ValueError(f"unknown kernel {name!r}")


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(n_bytes / PEAKS["hbm_bw"], n_ops / ops_per_s)


def scan_bound_s(kernel: str, queries: int, n: int, d: int,
                 words: int) -> float:
    """The bound of the work one exact scan of ``queries`` queries over
    ``n`` rows of width ``d`` (``words`` attribute words a row) needs of
    ``kernel``, counted unpadded: every row's distance to every query
    (``gather_dist_tile`` as one tile of all ``n`` rows), every row's
    subset deficit against every query (``bitset_dist``)."""
    if kernel == "gather_dist_tile":
        work = kernel_work(kernel, B=queries, tile=n, dp=d)
    else:
        work = kernel_work(kernel, B=queries, N=n, W=words,
                           popc_rate=POPC_RATE)
    return bound_s(*work)
