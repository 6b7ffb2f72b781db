"""Wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Dispatch is by the device of the tensors: CPU tensors go to the plain
PyTorch version in ``kernels/ref.py``; CUDA tensors launch the kernel (built
with nvcc at first use, ``kernels/_build.py``) or raise. There is no
fallback from the card to the plain version.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
without synchronising, raises when the launch reports a CUDA error, and adds
one to ``LAUNCHES[name]`` for each kernel it launches. An empty output needs
no launch: the wrapper returns it without calling the kernel or counting.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build, ref

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.SOURCES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*ts: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; raise otherwise."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
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
    if d * 4 > 48 * 1024:
        raise ValueError(f"d={d} exceeds the kernel's shared query buffer")
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
    multiple of ``tile``; ``base`` int32 [B] is clamped into range. Padded
    rows score against the zero vector, so callers mask them.
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
