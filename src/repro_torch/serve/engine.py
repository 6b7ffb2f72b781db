"""Serving engine: turn a FusedLayout into beam-search fetch closures
(counterpart of ``repro.serve.engine``).

``greedy_search`` takes a ``fetch_fn(ids, q32, q_norm) -> (d2, attrs)``
hook that replaces the default two-gather expansion. This module builds it
from a packed layout, so every expansion is one row gather through
``kernels.ops.fused_expand``: the hand-written CUDA kernel for a layout on
the card (the counterpart of the reference's ``use_kernel=True``), its
plain version for a layout on the CPU. f32 and int8 lanes take the same
kernel: the query is folded by ``FusedLayout.fold_query``. The attr words
are decoded with ``FusedLayout.unpack_attrs``, so the attrs dict is exactly
what ``AttrTable.gather`` would have produced.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .layout import FusedLayout


def make_fetch_fn(layout: FusedLayout):
    """Build a ``fetch_fn`` for ``greedy_search`` from a packed layout."""

    def fetch_fn(ids, q32, q_norm):
        q_eff, _ = layout.fold_query(q32)
        d2, words = ops.fused_expand(
            layout.packed, ids.to(torch.int32).contiguous(),
            q_eff.contiguous(), q_norm.contiguous(), d=layout.d)
        return d2, layout.unpack_attrs(words)

    return fetch_fn


class FusedEngine:
    """A layout and its fetch closure.

    ``gathers_per_expansion`` is the traffic contract: one packed row
    gather per expansion (the split path takes two, vectors and
    attributes); ``row_bytes`` the bytes each scored candidate pulls.
    """

    gathers_per_expansion = 1

    def __init__(self, layout: FusedLayout):
        self.layout = layout
        self.fetch_fn = make_fetch_fn(layout)

    @property
    def row_bytes(self) -> int:
        """Bytes pulled per scored candidate (one packed f32 row)."""
        return int(self.layout.packed.shape[1]) * 4
