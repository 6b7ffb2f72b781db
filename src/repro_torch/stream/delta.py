"""Growable delta segment: (vectors, attr rows) appended in amortized O(1)
(counterpart of ``repro.stream.delta``).

The mutable half of a :class:`~repro_torch.stream.StreamingJAGIndex`.
Appends land in host numpy buffers that double in capacity, so ``append``
never waits on a rebuild; the device view (a vector block and an
``AttrTable`` over exactly the live rows, on the segment's device) is made
on first use and cached until the next append. The executor's ``delta``
route scans it exactly; compaction folds it into the graph before it grows
past a set fraction of N.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.filters import AttrTable

_MIN_CAPACITY = 64


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class DeltaSegment:
    """Append-only (vectors, attributes) buffer with doubling capacity.

    Host buffers are the source of truth (the archive stores them);
    ``device()`` gives the tensors the delta scan reads, on ``device``.
    ``bit_weights`` never lives here: it is global, owned by the base
    table. Attr words are held as int32, as in ``AttrTable``.
    """

    def __init__(self, kind: str, n_bits: int, d: int,
                 attr_template: Dict[str, Tuple[np.dtype, tuple]], device):
        self.kind = kind
        self.n_bits = int(n_bits)
        self.d = int(d)
        self.dev = torch.device(device)
        self._template = dict(attr_template)
        self.reset()

    @classmethod
    def for_table(cls, table: AttrTable, d: int) -> "DeltaSegment":
        """An empty segment shaped like ``table``'s per-point rows, on the
        table's device."""
        template = {k: (_host(v[:0]).dtype, tuple(v.shape[1:]))
                    for k, v in table.data.items() if k != "bit_weights"}
        return cls(table.kind, table.n_bits, d, template, table.device)

    def _grow(self, need: int) -> None:
        cap = max(self._cap, _MIN_CAPACITY)
        while cap < need:
            cap *= 2
        if cap == self._cap:
            return
        xv = np.empty((cap, self.d), np.float32)
        xv[:self.n] = self._xv[:self.n]
        self._xv = xv
        for k, (dt, shape) in self._template.items():
            buf = np.empty((cap,) + shape, dt)
            buf[:self.n] = self._attr[k][:self.n]
            self._attr[k] = buf
        self._cap = cap

    def append(self, vectors, attrs: AttrTable) -> int:
        """Append a batch of rows; returns the new row count. ``attrs`` is
        an AttrTable of the segment's kind with one row per vector."""
        xv = _host(vectors).astype(np.float32, copy=False)
        if xv.ndim != 2 or xv.shape[1] != self.d:
            raise ValueError(f"vectors must be [M, {self.d}], "
                             f"got {xv.shape}")
        if attrs.kind != self.kind or attrs.n_bits != self.n_bits:
            raise ValueError(f"attr rows are {attrs.kind}/{attrs.n_bits}, "
                             f"segment is {self.kind}/{self.n_bits}")
        if attrs.n != xv.shape[0]:
            raise ValueError(f"{xv.shape[0]} vectors vs {attrs.n} attr rows")
        m = xv.shape[0]
        self._grow(self.n + m)
        self._xv[self.n:self.n + m] = xv
        for k in self._template:
            self._attr[k][self.n:self.n + m] = _host(attrs.data[k])
        self.n += m
        self._device = None
        return self.n

    def rows(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Host copies of exactly the live rows (persistence)."""
        return (self._xv[:self.n].copy(),
                {k: v[:self.n].copy() for k, v in self._attr.items()})

    def device(self) -> Tuple[torch.Tensor, AttrTable]:
        """(vectors f32 [n, d], AttrTable over the n live rows) on the
        segment's device, cached until the next append."""
        if self._device is None:
            xv, attrs = self.rows()
            self._device = (
                torch.from_numpy(xv).to(self.dev),
                AttrTable(self.kind, {k: torch.from_numpy(v).to(self.dev)
                                      for k, v in attrs.items()},
                          self.n_bits))
        return self._device

    def reset(self) -> None:
        """Drop every row (after compaction); the capacity goes too."""
        self.n = 0
        self._cap = 0
        self._xv = np.empty((0, self.d), np.float32)
        self._attr = {k: np.empty((0,) + shape, dt)
                      for k, (dt, shape) in self._template.items()}
        self._device: Optional[Tuple[torch.Tensor, AttrTable]] = None
