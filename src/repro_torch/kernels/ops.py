"""Wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Dispatch is by the device of the tensors: CPU tensors go to the plain
PyTorch version in ``kernels/ref.py``; CUDA tensors launch the kernel (built
with nvcc at first use, ``kernels/_build.py``) or raise. There is no
fallback from the card to the plain version. Tensors on the ``meta``
device (the dry run, ``launch/dryrun.py``, which checks shapes and dtypes
without memory) take the plain version too, which computes nothing there;
``flash_attention`` checks the shapes and returns an output of its shape
and dtype instead, since its plain version's loop over key blocks would
take the dry run's time.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
without synchronising, raises when the launch reports a CUDA error, and adds
one to ``LAUNCHES[name]`` for each kernel it launches. An empty output needs
no launch: the wrapper returns it without calling the kernel or counting.

No wrapper is differentiable: with grad mode on, every wrapper raises on an
input that requires grad, on either device, so a training path cannot run
a kernel whose output has no ``grad_fn``. Training attention goes through
``kernels/autograd.py``, whose forward calls ``flash_attention`` here with
grad mode off.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from . import _build, ref

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*ts: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; raise otherwise, and raise if grad mode is on and an input
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "kernel wrappers have no backward: a launch through ctypes "
            "returns an output without grad_fn, which would drop the "
            "gradient silently; differentiate attention through "
            "kernels.autograd.flash_attention, or call under torch.no_grad()")
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs) or all(d.type == "meta"
                                                 for d in devs):
        return False
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return True
    raise ValueError(f"kernel inputs on mixed devices: {sorted(map(str, devs))}")


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, *args) -> None:
    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = _build.entry(name)(*ptrs, dev.index or 0,
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


def fused_expand(packed: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                 q_norm: torch.Tensor, *, d: int):
    """One-gather beam expansion over the fused serving layout.

    packed f32 [N, d+1+A] rows of [vec | sq-norm | attr words], ids int32
    [B, C] (clamped into range), q f32 [B, d], q_norm f32 [B] -> (d2 f32
    [B, C], attr words f32 [B, C, A] holding the stored bits).
    """
    if not _on_card(packed, ids, q, q_norm):
        return ref.fused_expand(packed, ids, q, q_norm, d=d)
    N, row_w = packed.shape
    B, C = ids.shape
    A = row_w - d - 1
    if N == 0:
        raise ValueError("packed has no rows to gather")
    if A < 1:
        raise ValueError("packed rows must carry at least one attr word")
    _expect(packed, "packed", torch.float32, (N, row_w))
    _expect(ids, "ids", torch.int32, (B, C))
    _expect(q, "q", torch.float32, (B, d))
    _expect(q_norm, "q_norm", torch.float32, (B,))
    d2 = torch.empty((B, C), dtype=torch.float32, device=packed.device)
    words = torch.empty((B, C, A), dtype=torch.int32, device=packed.device)
    if d2.numel():
        _launch("fused_expand", packed, ids, q, q_norm, d2, words,
                B, C, N, d, A)
    return d2, words.view(torch.float32)


def gather_dist_tile(xb: torch.Tensor, base: torch.Tensor, q: torch.Tensor,
                     *, tile: int) -> torch.Tensor:
    """Contiguous-tile fused gather + distance: lane b scores rows
    ``[base[b]*tile, (base[b]+1)*tile)`` of xb against q[b] -> f32
    [B, tile], squared L2 clamped at 0. xb f32 [N_pad, d_pad] with N_pad a
    multiple of ``tile`` and, on the card, d_pad a multiple of 8; ``base``
    int32 [B] is clamped into range. Padded rows score against the zero
    vector, so callers mask them.
    """
    if not _on_card(xb, base, q):
        return ref.gather_dist_tile(xb, base, q, tile=tile)
    n_rows, dp = xb.shape
    B = base.shape[0]
    if n_rows == 0 or n_rows % tile:
        raise ValueError(f"xb rows {n_rows} are not a positive multiple of "
                         f"{tile}")
    _expect(xb, "xb", torch.float32, (n_rows, dp))
    _expect(base, "base", torch.int32, (B,))
    _expect(q, "q", torch.float32, (B, dp))
    if dp % 8 or xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("gather_dist_tile: the kernel's 16-byte copies need "
                         f"dp a multiple of 8 (got {dp}) and 16-byte aligned "
                         "xb and q")
    out = torch.empty((B, tile), dtype=torch.float32, device=xb.device)
    if out.numel():
        _launch("gather_dist_tile", xb, base, q, out, B, tile, dp, n_rows)
    return out


def bitset_dist(a: torch.Tensor, b: torch.Tensor, *,
                op: str = "xor") -> torch.Tensor:
    """Bitset distance matrix: a int32 [B, W], b int32 [N, W] packed words
    -> int32 [B, N]. op="xor": Hamming (dist_A); op="deficit":
    popcount(a & ~b) = |a \\ b| (dist_F with a = filter bits)."""
    if op not in ("xor", "deficit"):
        raise ValueError(f"op must be 'xor' or 'deficit', got {op!r}")
    if not _on_card(a, b):
        return ref.bitset_dist(a, b, op=op)
    B, W = a.shape
    N = b.shape[0]
    _expect(a, "a", torch.int32, (B, W))
    _expect(b, "b", torch.int32, (N, W))
    out = torch.empty((B, N), dtype=torch.int32, device=a.device)
    if out.numel():
        _launch("bitset_dist", a, b, out, B, N, W,
                1 if op == "deficit" else 0)
    return out


def subset_deficit(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """|f \\ a| matrix [B, N] (subset dist_F)."""
    return bitset_dist(f, a, op="deficit")


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed Hamming distance matrix [B, N]."""
    return bitset_dist(a, b, op="xor")


def gather_dist(xb: torch.Tensor, ids: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Row-granular fused gather + distance: xb [N, d] f32 or bf16, ids
    int32 [B, C] (clipped into [0, N)), q [B, d] -> f32 [B, C], the
    difference form sum_k (xb[ids[b, c], k] - q[b, k])^2. Any d, B and C;
    on the card rows that start off a 16-byte boundary take the kernel's
    single-value loads."""
    if not _on_card(xb, ids, q):
        return ref.gather_dist(xb, ids, q)
    N, d = xb.shape
    B, C = ids.shape
    if N == 0:
        raise ValueError("xb has no rows to gather")
    if xb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xb: dtype {xb.dtype}, expected float32 or bfloat16")
    _expect(xb, "xb", xb.dtype, (N, d))
    _expect(ids, "ids", torch.int32, (B, C))
    q = q.float().contiguous()
    _expect(q, "q", torch.float32, (B, d))
    out = torch.empty((B, C), dtype=torch.float32, device=xb.device)
    if out.numel():
        _launch("gather_dist", xb, ids, q, out, B, C, N, d,
                int(xb.dtype == torch.bfloat16))
    return out


def l2dist(q: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix: q [B, d], xb [N, d], both f32 or both
    bf16 -> f32 [B, N] = max(|q|^2 + |x|^2 - 2 q.x, 0). On the card the
    product runs on the TF32 tensor cores as three passes over hi and lo
    halves of each f32 operand (``csrc/tf32x3.cuh``), within 1e-5 (|q|^2 +
    |x|^2) of the plain version; bf16 is exact in TF32 and takes one
    pass."""
    if not _on_card(q, xb):
        return ref.l2dist(q, xb)
    B, d = q.shape
    N = xb.shape[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    _expect(q, "q", q.dtype, (B, d))
    _expect(xb, "xb", q.dtype, (N, d))
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if out.numel():
        scratch = torch.empty(_scratch_bytes("l2dist", N, d),
                              dtype=torch.uint8, device=q.device)
        _launch("l2dist", q, xb, out, scratch, B, N, d,
                int(q.dtype == torch.bfloat16))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scores_bf16: bool = False,
                    p_bf16: bool = False) -> torch.Tensor:
    """Online-softmax attention with f32 accumulation (see
    ``ref.flash_attention``).

    ``scores_bf16`` / ``p_bf16`` are the LM's ``attn_scores_bf16`` and
    ``attn_p_bf16`` knobs: with either, the inputs are cast to bf16 (the
    reference's ``.astype``) and the call launches the bf16-score variant
    of the tensor-core kernel (``flash_attention_bf16``, in
    ``csrc/flash_attention.cu``), with the reference's rounding points;
    the output comes back in q's dtype. A width that kernel cannot take (D
    not a multiple of 8) raises: there is no plain fallback.

    q [B, H, Tq, D], k/v [B, Hkv, Tk, D], all f32 or all bf16, D <= 256
    -> [B, H, Tq, D] in q's dtype. Query head h reads kv head h // (H/Hkv).
    Causal attention (mask row >= col) needs Tq == Tk and raises otherwise.
    The kernels mask ragged Tq, Tk and D themselves, so nothing is padded.

    Two kernels, picked by dtype and width, both on the tensor cores: bf16
    with D a multiple of 8 (and 16-byte aligned tensors) runs on wgmma
    (``flash_attention``, counted under that name); float32, and bf16 of
    another width, runs both products as three TF32 passes over hi and lo
    halves (``flash_attention_f32``: wgmma up to D = 128, mma.sync above),
    after a pre-pass that splits K and V once into scratch (up to D =
    128); both kernels sum short runs of instructions on the CUDA cores,
    which keeps their error against float64 at or under the plain float32
    version's. Any B * H: the kernel takes heads in chunks of 65535.

    There is no backward kernel, as the TPU kernel has none (the reference
    trains through its XLA scan). Training calls this wrapper through
    ``kernels.autograd.FlashAttention``: its forward is this call (the
    kernel on the card, the plain version on the CPU), and its backward
    differentiates ``ref.flash_attention`` recomputed from q, k and v.
    """
    on_card = _on_card(q, k, v)
    if not on_card and q.device.type != "meta":
        return ref.flash_attention(q, k, v, causal=causal,
                                   scores_bf16=scores_bf16, p_bf16=p_bf16)
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if causal and Tq != Tk:
        raise ValueError(f"causal attention needs Tq == Tk, got {Tq}, {Tk}")
    if H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    if not on_card:                        # meta: shapes and dtypes only
        if k.shape != v.shape or k.shape[::3] != q.shape[::3]:
            raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} do "
                             f"not fit q {tuple(q.shape)}")
        return torch.empty_like(q)
    if D > 256:
        raise ValueError(f"head_dim {D} > 256, the kernels' widest tile")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    _expect(q, "q", q.dtype, (B, H, Tq, D))
    _expect(k, "k", q.dtype, (B, Hkv, Tk, D))
    _expect(v, "v", q.dtype, (B, Hkv, Tk, D))
    knobbed = scores_bf16 or p_bf16
    if knobbed:
        if D % 8:
            raise ValueError(f"head_dim {D}: the bf16-score kernel takes a "
                             "multiple of 8")
        out_dtype = q.dtype
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = torch.empty_like(q)
    if not out.numel():
        return out.to(out_dtype) if knobbed else out
    scale = 1.0 / math.sqrt(D)
    if q.dtype == torch.bfloat16 and D % 8 == 0:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the tensor-core kernel's TMA "
                                 "copies need a 16-byte aligned tensor")
        if knobbed:
            _launch("flash_attention_bf16", q, k, v, out, B, H, Hkv, Tq, Tk,
                    D, int(causal), scale, 2 if scores_bf16 else 1)
            return out.to(out_dtype)
        _launch("flash_attention", q, k, v, out, B, H, Hkv, Tq, Tk, D,
                int(causal), scale)
    else:
        scratch = torch.empty(
            _scratch_bytes("flash_attention_f32", B, Hkv, Tk, D),
            dtype=torch.uint8, device=q.device)
        _launch("flash_attention_f32", q, k, v, out, scratch, B, H, Hkv, Tq,
                Tk, D, int(causal), int(q.dtype == torch.bfloat16), scale)
    return out


def _scratch_bytes(name: str, *shape: int) -> int:
    """Bytes of scratch kernel ``name`` needs for these sizes, from its
    library's ``<name>_scratch``: the images of the operand tiles that its
    pre-pass splits once for every block that reads them
    (``csrc/l2dist.cu``, ``csrc/flash_attention_f32.cu``)."""
    fn = getattr(_build.library(name), f"{name}_scratch")
    fn.argtypes = [ctypes.c_int] * len(shape)
    fn.restype = ctypes.c_longlong
    return int(fn(*shape))
