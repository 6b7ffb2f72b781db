"""Fused serving row layout: [vec | sq-norm | attr words] in one matrix
(counterpart of ``repro.serve.layout``, float32 lanes).

    col 0..d-1 : vector lanes (f32)
    col d      : squared L2 norm of the vector
    col d+1..  : attr words (filters.pack_attr_words, bit-exact payloads)

One row gather per beam expansion (the ``fused_expand`` kernel on the card)
then feeds the whole comparator, instead of the default path's two gathers.
The int8 lanes of the reference come with the int8 slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.distances import sq_norms
from ..core.filters import AttrTable, pack_attr_words, unpack_attr_words

VEC_DTYPES = ("f32",)


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """A packed serving matrix plus the metadata needed to read it.

    packed      : f32 [N, d + 1 + A] rows of [vec | sq-norm | attr words]
    q_scale     : f32 [d] per-dim query fold factor (ones for f32 rows)
    bit_weights : f32 [L] weighted-subset distances (empty [0] when unused)
    kind/n_bits : the attribute family of the attr words
    d           : vector lane count; vec_dtype: "f32"
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


def build_layout(xb: torch.Tensor, attr: AttrTable, *,
                 vec_dtype: str = "f32") -> FusedLayout:
    """Pack (vectors, attributes) into an f32 FusedLayout whose distances
    equal the default path's bit for bit (same norms, same dot)."""
    if vec_dtype not in VEC_DTYPES:
        raise ValueError(f"vec_dtype must be one of {VEC_DTYPES}; the int8 "
                         f"lanes are not ported yet")
    x32 = xb.to(torch.float32)
    words = pack_attr_words(attr)
    bw = attr.data.get("bit_weights")
    bw = (bw.to(torch.float32) if bw is not None
          else torch.zeros((0,), dtype=torch.float32, device=xb.device))
    packed = torch.cat([x32, sq_norms(x32)[:, None], words], dim=1)
    return FusedLayout(packed.contiguous(),
                       torch.ones((x32.shape[1],), dtype=torch.float32,
                                  device=xb.device),
                       bw, attr.kind, attr.n_bits, int(x32.shape[1]),
                       vec_dtype)
