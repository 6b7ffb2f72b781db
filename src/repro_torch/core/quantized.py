"""int8 serving state (counterpart of ``repro.core.quantized``).

1. **int8 database**: per-dimension symmetric quantization of the vectors
   the graph traversal reads; the beam's survivors are re-ranked with the
   full-precision rows at the end. A quarter of the f32 bytes per code.
2. **fused rows**: ``serve/layout.py`` packs ``[int8 codes | norm | attr
   words]`` (codes widened to f32) so one gather per expansion feeds the
   comparator; ``fuse_rows`` below is the single-f32-attr-column special
   case the reference keeps.

``torch.round`` and ``jnp.round`` both round half to even and every
quotient is a true division, so the codes and scales equal the reference's
bit for bit, on the CPU and on the card. The dequantized norms are summed
over d in order (:func:`dequant_sq_norms`): one fixed order on every device
and batch size.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .distances import INF, gathered_dot, lex_sort


def quantize_int8(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dim symmetric int8: (codes int8 [N, d], scale f32 [d]);
    ``scale = max|x| / 127`` floored at 1e-12, codes ``clip(round(x /
    scale), -127, 127)``."""
    x = xb.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=0)
    # a tensor divisor: CUDA multiplies by the reciprocal of a scalar one,
    # which can miss the quotient by an ulp
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequant_sq_norms(codes: torch.Tensor, scale: torch.Tensor
                     ) -> torch.Tensor:
    """Squared norms of the dequantized rows ``codes * scale``, f32 [N],
    each a rounded square then a rounded add, over d in order."""
    out = torch.zeros(codes.shape[:1], dtype=torch.float32,
                      device=codes.device)
    for k in range(codes.shape[1]):
        v = codes[:, k].to(torch.float32) * scale[k]
        out = out + v * v
    return out


def make_int8_dist_fn(scale: torch.Tensor):
    """``gathered_d2``-compatible distance over an int8 database: ``xb`` is
    the int8 codes, ``xb_norm`` the dequantized row norms."""
    def dist_fn(xb_q, xb_norm, ids, q32, q_norm):
        idc = ids.clamp(0, xb_q.shape[0] - 1)
        rows = xb_q[idc].to(torch.float32) * scale               # dequant
        d2 = xb_norm[idc] - 2.0 * gathered_dot(rows, q32) + q_norm[:, None]
        return torch.clamp_min(d2, 0.0)
    return dist_fn


def rerank_exact(xb: torch.Tensor, xb_norm: torch.Tensor, res_ids, res_prim,
                 queries: torch.Tensor, k: int):
    """Re-rank approximate candidates with full-precision distances: keeps
    the primary (filter distance), replaces the secondary with the exact
    d2, and returns the re-sorted (ids, primary, d2)[:, :k]."""
    q32 = queries.to(torch.float32)
    qn = torch.sum(q32 * q32, dim=-1)
    ok = res_ids >= 0
    ids_c = res_ids.clamp_min(0)
    d2 = (xb_norm[ids_c] - 2.0 * gathered_dot(xb[ids_c], q32)
          + qn[:, None])
    d2 = torch.where(ok, torch.clamp_min(d2, 0.0), INF)
    prim = torch.where(ok, res_prim, INF)
    p, s, i = lex_sort(prim, d2, res_ids)
    return i[:, :k], p[:, :k], s[:, :k]


def fuse_rows(xb_q: torch.Tensor, xb_norm: torch.Tensor,
              attr_value: torch.Tensor) -> torch.Tensor:
    """[codes as f32 | norm | one f32 attr column] as one f32 matrix."""
    return torch.cat([xb_q.to(torch.float32),
                      xb_norm.to(torch.float32)[:, None],
                      attr_value.to(torch.float32)[:, None]], dim=1)
