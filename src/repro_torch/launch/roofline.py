"""Time bounds of the port's work on one NVIDIA H100 (counterpart of
``repro.launch.roofline`` and of ``repro.launch.mesh.HW``).

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and the operations it does over the peak rate of the pipe
that runs them:

    t_mem  = bytes / HW["hbm_bw"]
    t_comp = ops / rate        (FP32 CUDA cores, bf16 or TF32 tensor
                                cores, or the popcount pipe)

``kernel_work`` counts bytes and operations from a call's shapes for each
of the six kernels in ``csrc/``, by the same formulas for whatever code
computes the function, so a bound depends on the work and not on the
kernel that does it. Kernels that run float32 products as split TF32
(``l2dist``, ``flash_attention_f32``) count ``TF32_PASSES`` products per
flop at the TF32 rate; ``split_bound_ms`` also gives the same flops at the
FP32 rate.

``Roofline`` records one piece of work against that bound; ``format_row``
prints it on one line and ``to_dict`` keeps it as JSON (the dry run's and
the perf harness's rows, ``launch/dryrun.py``, ``launch/perf.py``). The
card's memory and the production meshes are in ``launch/mesh.py``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

HW = dict(  # NVIDIA H100 SXM, data sheet, dense rates, at its 700 W limit
    hbm_bw=3.35e12,            # bytes/s, HBM3
    fp32_flops=67e12,          # FP32 outside the tensor cores
    bf16_flops=989e12,         # bf16 tensor cores
    tf32_flops=495e12,         # TF32 tensor cores
    tf32_passes=3,             # split-TF32 products of float32 operands
    popc_per_clock=16,         # popcounts a clock an SM, compute capability
                               # 9.0 (CUDA C++ Programming Guide, throughput
                               # of native arithmetic instructions)
    l2_bytes=50e6,
)
TF32_PASSES = HW["tf32_passes"]

KERNELS = ("fused_expand", "gather_dist_tile", "bitset_dist", "gather_dist",
           "l2dist", "flash_attention", "flash_attention_f32",
           "flash_attention_bf16")


def popc_ops_per_s(sms: int, sm_clock_mhz: float) -> float:
    """The card's popcount rate: SMs x 16 a clock x the SM clock (MHz, as
    ``nvidia-smi --query-gpu=clocks.max.sm`` prints it)."""
    return sms * HW["popc_per_clock"] * sm_clock_mhz * 1e6


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = HW["fp32_flops"]) -> Tuple[float, str]:
    """(bound in ms, "bytes" or "operations"): the larger of the two
    times."""
    t_bytes = n_bytes / HW["hbm_bw"] * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str, float]:
    """(bound ms, by, FP32-rate ms) of a kernel whose ``n_ops`` float32
    flops run as ``TF32_PASSES`` passes on the TF32 tensor cores; the third
    figure is the same work at the FP32 rate of the CUDA cores."""
    b, o = bound_ms(n_bytes, TF32_PASSES * n_ops, HW["tf32_flops"])
    return b, o, bound_ms(n_bytes, n_ops)[0]


def kernel_work(name: str, **shape) -> Tuple[float, float, float]:
    """(bytes, operations, operations a second) of one call of kernel
    ``name`` at ``shape``:

    fused_expand(B, C, d, A)        packed rows [vec | norm | A words]
    gather_dist(B, C, d)
    gather_dist_tile(B, tile, dp)   one tile of ``tile`` rows per lane
    bitset_dist(B, N, W, popc_rate) popcounts at the card's popcount rate
    l2dist(B, N, d)                 split TF32 (3 passes at the TF32 rate)
    flash_attention(B, H, Hkv, T, D)      causal, bf16
    flash_attention_bf16(B, H, Hkv, T, D) causal, bf16 (the score knobs)
    flash_attention_f32(B, H, Hkv, T, D)  causal, split TF32

    Bytes count each input row read once and each output written once:
    fused_expand reads a packed row and its id and writes d2 and A words
    per candidate, plus each lane's query and norm; the attention reads q,
    k, v and writes out. Operations count multiplies and adds (2 a
    product term; gather_dist's difference form 3); causal attention does
    half of its 4 B H T^2 D.
    """
    s = shape
    if name == "fused_expand":
        B, C, d, A = s["B"], s["C"], s["d"], s["A"]
        return (B * C * ((d + 1 + A) * 4 + 4 + 4 + A * 4) + B * (d + 1) * 4,
                2 * B * C * d, HW["fp32_flops"])
    if name == "gather_dist":
        B, C, d = s["B"], s["C"], s["d"]
        return (B * C * (d * 4 + 4 + 4) + B * d * 4, 3 * B * C * d,
                HW["fp32_flops"])
    if name == "gather_dist_tile":
        B, tile, dp = s["B"], s["tile"], s["dp"]
        return ((tile * dp + B * dp + B + B * tile) * 4, 2 * B * tile * dp,
                HW["fp32_flops"])
    if name == "bitset_dist":
        B, N, W = s["B"], s["N"], s["W"]
        return (B * W + N * W + B * N) * 4, B * N * W, s["popc_rate"]
    if name == "l2dist":
        B, N, d = s["B"], s["N"], s["d"]
        return ((B * d + N * d + B * N) * 4, TF32_PASSES * 2 * B * N * d,
                HW["tf32_flops"])
    if name in ("flash_attention", "flash_attention_f32",
                "flash_attention_bf16"):
        B, H, Hkv, T, D = s["B"], s["H"], s["Hkv"], s["T"], s["D"]
        f32 = name == "flash_attention_f32"
        it = 4 if f32 else 2
        flops = 2 * B * H * T * T * D
        n_bytes = (2 * B * H * T * D + 2 * B * Hkv * T * D) * it
        if f32:
            return n_bytes, TF32_PASSES * flops, HW["tf32_flops"]
        return n_bytes, flops, HW["bf16_flops"]
    raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")


def kernel_bound_ms(name: str, **shape) -> Tuple[float, str]:
    """``bound_ms`` of ``kernel_work(name, **shape)``."""
    n_bytes, n_ops, rate = kernel_work(name, **shape)
    return bound_ms(n_bytes, n_ops, rate)


def kernel_split_bound_ms(name: str, **shape) -> Tuple[float, str, float]:
    """``split_bound_ms`` of a split-TF32 kernel's work: (bound ms, by,
    the same flops at the FP32 rate in ms)."""
    n_bytes, n_ops, _ = kernel_work(name, **shape)
    return split_bound_ms(n_bytes, n_ops / TF32_PASSES)


@dataclasses.dataclass
class Roofline:
    """One piece of work against the card's bound, and its measured time:
    ``t_comp`` = flops / rate, ``t_mem`` = bytes / HBM rate, both in
    seconds; ``bottleneck`` names the larger."""
    name: str
    flops: float
    bytes: float
    t_comp: float
    t_mem: float
    bottleneck: str
    measured_s: Optional[float] = None

    @property
    def bound_s(self) -> float:
        return max(self.t_comp, self.t_mem)

    @property
    def bound_share(self) -> Optional[float]:
        """The bound over the measured time: 1.0 is the card's limit."""
        if not self.measured_s:
            return None
        return self.bound_s / self.measured_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(bound_s=self.bound_s, bound_share=self.bound_share)
        return d


def format_row(r: Roofline) -> str:
    """One line: the work, the two terms, the bound and, when measured,
    the time and its share of the bound."""
    meas = (f" measured={r.measured_s * 1e3:.3f}ms "
            f"share={r.bound_share:.4f}" if r.measured_s else "")
    return (f"{r.name:40s} flops={r.flops:.4g} bytes={r.bytes:.4g} "
            f"comp={r.t_comp * 1e3:.3f}ms mem={r.t_mem * 1e3:.3f}ms "
            f"-> {r.bottleneck}{meas}")


def save_all(rows, path: str):
    """Write rows as the reference's file: a JSON list of ``to_dict()``s,
    indent 1."""
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in rows], f, indent=1)


def _from_dict(d: dict) -> Roofline:
    if "arch" in d:     # the reference's row: one card's HLO terms
        return Roofline(f"{d['arch']} x {d['shape']} x {d['mesh']}",
                        d["flops_per_chip"], d["bytes_per_chip"],
                        d["t_comp"], d["t_mem"], d["bottleneck"])
    return Roofline(**{f.name: d[f.name]
                       for f in dataclasses.fields(Roofline) if f.name in d})


def load_all(path: str):
    """Rows from a file of ``save_all``'s, or of the reference's
    ``save_all`` (its per-card flops, bytes, the two terms and the
    bottleneck; the collective term has no counterpart on one card)."""
    with open(path) as f:
        return [_from_dict(d) for d in json.load(f)]


def analyze(name: str, *, n_bytes: float, n_ops: float, rate: float,
            measured_s: Optional[float] = None) -> Roofline:
    """The roofline of one piece of work at ``rate`` operations a
    second."""
    t_comp = n_ops / rate
    t_mem = n_bytes / HW["hbm_bw"]
    return Roofline(name, n_ops, n_bytes, t_comp, t_mem,
                    "compute" if t_comp > t_mem else "memory", measured_s)


def lm_model_flops(cfg, batch: int, tokens: int, kind: str) -> float:
    """The useful flops of one LM call (``LMConfig``).

    ``kind="prefill"``: ``batch`` prompts of ``tokens`` tokens, every
    layer's projections and FFN for each token, causal attention (half of
    4 T^2 hd a head), and the LM head for the last position (what
    ``transformer.prefill`` computes). ``kind="decode"``: one new token a
    lane at context length ``tokens``: projections, FFN, the LM head and
    attention over ``tokens + 1`` keys. ``kind="train"``: one training
    step over ``batch`` sequences of ``tokens`` tokens, forward and
    backward, 3 x (2 B T (sum of the layers' weights + head) + causal
    attention): the head for every position, the backward twice the
    forward. The remat recompute is not counted: it is work the step
    chooses, not work the model needs.

    A MoE layer counts the one expert a token takes (top-1), the shared
    expert and the router, not the capacity's padding or the dropped
    tokens. A chunked layer (``attn_chunk``, not global) attends within
    its chunk: the sum of each chunk's length squared in place of T^2,
    and for decode the keys of the new token's chunk.
    """
    from ..models.transformer import _layer_flags
    d, H, hd, C = cfg.d_model, cfg.n_heads, cfg.hd, cfg.attn_chunk
    ffn = 3 * d * cfg.d_ff
    weights = keys = 0          # a token's weights; keys summed over layers
    for i in range(cfg.n_layers):
        weights += d * hd * (2 * H + 2 * cfg.n_kv_heads) + ffn
        if cfg._is_moe(i):
            weights += ffn * cfg.shared_expert + d * cfg.n_experts
        chunked = not _layer_flags(cfg, i)[0]
        if kind == "decode":
            keys += tokens % C + 1 if chunked else tokens + 1
        else:
            keys += ((tokens // C) * C * C + (tokens % C) ** 2 if chunked
                     else tokens * tokens)
    head = cfg.padded_vocab * d
    if kind == "prefill":
        return float(2 * batch * tokens * weights + 2 * batch * H * keys * hd
                     + 2 * batch * head)
    if kind == "decode":
        return float(2 * batch * (weights + head)
                     + 4 * batch * H * keys * hd)
    if kind == "train":
        return float(3 * (2 * batch * tokens * (weights + head)
                          + 2 * batch * H * keys * hd))
    raise ValueError(f"kind must be 'prefill', 'decode' or 'train', got "
                     f"{kind!r}")
