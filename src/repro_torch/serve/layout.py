"""Fused serving row layout: [vec | sq-norm | attr words] in one matrix
(counterpart of ``repro.serve.layout``).

    col 0..d-1 : vector lanes: f32 values, or int8 codes widened to f32
    col d      : squared L2 norm of the (dequantized) vector
    col d+1..  : attr words (filters.pack_attr_words, bit-exact payloads)

One row gather per beam expansion (the ``fused_expand`` kernel on the card)
then feeds the whole comparator, instead of the default path's two gathers.
int8 rows keep the kernel's arithmetic by folding the scale into the query:
``codes . (q * scale)`` stands for ``dequant(codes) . q``, and the norm
lane holds the dequantized norm. ``q_scale`` is ones for f32 rows, so the
engine always folds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.distances import sq_norms
from ..core.filters import AttrTable, pack_attr_words, unpack_attr_words
from ..device import resolve_device

VEC_DTYPES = ("f32", "int8")


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """A packed serving matrix plus the metadata needed to read it.

    packed      : f32 [N, d + 1 + A] rows of [vec | sq-norm | attr words]
    q_scale     : f32 [d] per-dim query fold factor (ones for f32 rows, the
                  dequantization scale for int8 rows)
    bit_weights : f32 [L] weighted-subset distances (empty [0] when unused)
    kind/n_bits : the attribute family of the attr words
    d           : vector lane count; vec_dtype: "f32" | "int8"
    """
    packed: torch.Tensor
    q_scale: torch.Tensor
    bit_weights: torch.Tensor
    kind: str
    n_bits: int
    d: int
    vec_dtype: str = "f32"

    @property
    def n(self) -> int:
        return self.packed.shape[0]

    @property
    def n_attr_words(self) -> int:
        return self.packed.shape[1] - self.d - 1

    def unpack_attrs(self, words: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Decode gathered attr words [..., A] into an attrs dict."""
        bw = self.bit_weights if self.bit_weights.shape[0] else None
        return unpack_attr_words(self.kind, words, self.n_bits, bw)

    def fold_query(self, q: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q_eff, q_norm): the scale-folded query and its unfolded
        squared norm."""
        q32 = q.to(torch.float32)
        return q32 * self.q_scale[None, :], torch.sum(q32 * q32, dim=-1)


def build_layout(xb: torch.Tensor, attr: AttrTable, *,
                 vec_dtype: str = "f32") -> FusedLayout:
    """Pack (vectors, attributes) into a FusedLayout.

    "f32" reproduces the default path's distances bit for bit (same norms,
    same dot); "int8" stores per-dim symmetric codes widened to f32 and
    folds the scale into the query.
    """
    if vec_dtype not in VEC_DTYPES:
        raise ValueError(f"vec_dtype must be one of {VEC_DTYPES}")
    x32 = xb.to(torch.float32)
    if vec_dtype == "int8":
        from ..core.quantized import dequant_sq_norms, quantize_int8
        codes, q_scale = quantize_int8(x32)
        vec, norm = codes.to(torch.float32), dequant_sq_norms(codes, q_scale)
    else:
        vec, norm = x32, sq_norms(x32)
        q_scale = torch.ones((x32.shape[1],), dtype=torch.float32,
                             device=xb.device)
    bw = attr.data.get("bit_weights")
    bw = (bw.to(torch.float32) if bw is not None
          else torch.zeros((0,), dtype=torch.float32, device=xb.device))
    packed = torch.cat([vec, norm[:, None], pack_attr_words(attr)], dim=1)
    return FusedLayout(packed.contiguous(), q_scale, bw, attr.kind,
                       attr.n_bits, int(x32.shape[1]), vec_dtype)


def extend_layout(layout: FusedLayout, xv: torch.Tensor,
                  attr: AttrTable) -> FusedLayout:
    """Append rows to a packed f32 layout without re-packing its rows.

    Every lane of an f32 row depends on that row alone, so packing only
    the new rows gives ``build_layout`` over the concatenation bit for bit.
    int8 layouts do not extend: their scale is global, so the whole
    database would need re-quantizing; callers rebuild them lazily.
    """
    if layout.vec_dtype != "f32":
        raise ValueError("only f32 layouts extend losslessly; rebuild int8 "
                         "layouts after compaction (global quant scale)")
    if attr.kind != layout.kind or attr.n_bits != layout.n_bits:
        raise ValueError(f"attr rows are {attr.kind}/{attr.n_bits}, layout "
                         f"is {layout.kind}/{layout.n_bits}")
    x32 = xv.to(torch.float32)
    rows = torch.cat([x32, sq_norms(x32)[:, None], pack_attr_words(attr)],
                     dim=1)
    return dataclasses.replace(
        layout, packed=torch.cat([layout.packed, rows]).contiguous())


def save_layout(path: str, layout: FusedLayout) -> None:
    """Persist a packed layout in the reference's npz format; the lanes are
    stored as raw uint32, so attr words round-trip bit for bit."""
    np.savez_compressed(
        path,
        packed_bits=layout.packed.cpu().numpy().view(np.uint32),
        q_scale=layout.q_scale.cpu().numpy(),
        bit_weights=layout.bit_weights.cpu().numpy(),
        kind=layout.kind, n_bits=layout.n_bits, d=layout.d,
        vec_dtype=layout.vec_dtype)


def load_layout(path: str, device=None) -> FusedLayout:
    """A layout saved by :func:`save_layout` (or the reference's), on
    ``device`` (default "cuda")."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        return FusedLayout(
            torch.from_numpy(z["packed_bits"].view(np.float32)).to(dev),
            torch.from_numpy(z["q_scale"]).to(dev),
            torch.from_numpy(z["bit_weights"]).to(dev),
            str(z["kind"]), int(z["n_bits"]), int(z["d"]),
            str(z["vec_dtype"]))
