"""Filter and attribute representations for the four filter families in JAG.

PyTorch counterpart of ``repro.core.filters``. The paper (§2, §3.1) defines
four filter constraints: Label equality, numeric Range, Subset containment
and arbitrary Boolean predicates.

Layouts (torch has no usable uint32, so every 32-bit word is held as int32
with the same bits; shifts are masked afterwards because ``>>`` on int32
fills with the sign bit):
  * label   : ``int32[N]``
  * range   : ``float32[N]``
  * subset  : bit-packed words ``int32[N, W]`` with ``W = ceil(L / 32)``
  * boolean : assignment ``int32[N]`` (L <= MAX_BOOL_VARS bits); the filter
              carries a per-query distance table ``float32[B, 2**L]`` built by
              min-plus relaxation on the hypercube, so ``dist_F`` is a gather.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import to_tensor

LABEL = "label"
RANGE = "range"
SUBSET = "subset"
BOOLEAN = "boolean"
KINDS = (LABEL, RANGE, SUBSET, BOOLEAN)

MAX_BOOL_VARS = 20  # distance table is 2**L floats; 20 -> 4 MiB per query.


def kind_components(kind: str) -> Tuple[str, ...]:
    """Atomic components of a (possibly composite, ``"label+range"``) kind."""
    return tuple(kind.split("+"))


def is_composite(kind: str) -> bool:
    return "+" in kind


# ---------------------------------------------------------------------------
# bit packing helpers (32-bit words held as int32)
# ---------------------------------------------------------------------------

def n_words(n_bits: int) -> int:
    return (int(n_bits) + 31) // 32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def bit_of(pos: torch.Tensor) -> torch.Tensor:
    """int32 word with only bit ``pos`` (0..31) set; bit 31 is negative."""
    return wrap_i32(torch.ones_like(pos, dtype=torch.int64)
                    << pos.to(torch.int64))


def pack_bits(bits, device=None) -> torch.Tensor:
    """Pack a boolean array [..., L] into int32 words [..., ceil(L/32)]."""
    bits = to_tensor(bits, torch.bool, device)
    L = bits.shape[-1]
    W = n_words(L)
    pad = W * 32 - L
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (W, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    return wrap_i32(torch.sum(b << shifts, dim=-1))


def unpack_bits(words: torch.Tensor, L: int) -> torch.Tensor:
    """Unpack int32 words [..., W] into boolean [..., L]."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return bits[..., :L].to(torch.bool)


def popc32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise population count of int32 words (as unsigned) -> int32.

    SWAR bit tricks in int64, where no shift drags a sign bit along.
    """
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words, summed over the last axis."""
    return torch.sum(popc32(x), dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# attr-word codec: per-point attributes <-> f32 "words" for the fused layout
#
# The fused serving row packs [vec | norm | attr words] into one float32
# matrix. Integer attributes are bitcast (tensor.view(torch.float32) on int32
# storage), never value-cast, so arbitrary 32-bit payloads round-trip
# exactly; downstream code only copies or gathers attr lanes.
# ---------------------------------------------------------------------------

def attr_word_width(kind: str, n_bits: int = 0) -> int:
    """Number of f32 attr words per row in the fused serving layout."""
    if is_composite(kind):
        return sum(attr_word_width(k, n_bits) for k in kind_components(kind))
    if kind in (LABEL, RANGE, BOOLEAN):
        return 1
    if kind == SUBSET:
        return n_words(n_bits)
    raise ValueError(kind)


def pack_attr_words(table: "AttrTable") -> torch.Tensor:
    """Encode per-point attributes as f32 words [N, A] (bitcast lanes)."""
    k = table.kind
    if is_composite(k):
        return torch.cat(
            [pack_attr_words(AttrTable(k2, table.data, table.n_bits))
             for k2 in kind_components(k)], dim=-1)
    if k == LABEL:
        return table.data["label"].contiguous().view(torch.float32)[:, None]
    if k == RANGE:
        return table.data["value"].to(torch.float32)[:, None]
    if k == SUBSET:
        return table.data["bits"].contiguous().view(torch.float32)
    if k == BOOLEAN:
        return table.data["assign"].contiguous().view(torch.float32)[:, None]
    raise ValueError(k)


def unpack_attr_words(kind: str, words: torch.Tensor, n_bits: int = 0,
                      bit_weights: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Decode gathered f32 attr words [..., A] back into an attrs dict
    shaped like ``AttrTable.gather`` for the same ids."""
    if is_composite(kind):
        out: Dict[str, torch.Tensor] = {}
        off = 0
        for k2 in kind_components(kind):
            w = attr_word_width(k2, n_bits)
            out.update(unpack_attr_words(
                k2, words[..., off:off + w], n_bits,
                bit_weights if k2 == SUBSET else None))
            off += w
        return out
    if kind == LABEL:
        return {"label": words[..., 0].view(torch.int32)}
    if kind == RANGE:
        return {"value": words[..., 0]}
    if kind == SUBSET:
        out = {"bits": words.view(torch.int32)}
        if bit_weights is not None:
            out["bit_weights"] = bit_weights
        return out
    if kind == BOOLEAN:
        return {"assign": words[..., 0].view(torch.int32)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# attribute table (per-point metadata)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttrTable:
    """Per-point attributes for one dataset.

    data layout per kind:
      label   : {"label": int32[N]}
      range   : {"value": float32[N]}
      subset  : {"bits": int32[N, W]} (+ optional "bit_weights": f32[L])
      boolean : {"assign": int32[N]}
    """
    kind: str
    data: Dict[str, torch.Tensor]
    n_bits: int = 0

    @property
    def n(self) -> int:
        return next(iter(self.data.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    def gather(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Attribute rows for ids of any shape, clamped into [0, n)."""
        idc = ids.clamp(0, self.n - 1)
        return {k: (v if k == "bit_weights" else v[idc])
                for k, v in self.data.items()}

    def to(self, device) -> "AttrTable":
        return AttrTable(self.kind, {k: v.to(device)
                                     for k, v in self.data.items()},
                         self.n_bits)

    def append(self, other: "AttrTable") -> "AttrTable":
        """Rows of ``other`` after this table's rows (the streaming layer's
        live base + delta table). The global ``bit_weights`` are kept from
        ``self``; ``other`` must agree on kind and n_bits."""
        if other.kind != self.kind or other.n_bits != self.n_bits:
            raise ValueError(
                f"cannot append {other.kind}/{other.n_bits} rows to a "
                f"{self.kind}/{self.n_bits} table")
        return AttrTable(self.kind, {
            k: (v if k == "bit_weights"
                else torch.cat([v, other.data[k].to(v.device)]))
            for k, v in self.data.items()}, self.n_bits)


def label_table(labels, device=None) -> AttrTable:
    return AttrTable(LABEL, {"label": to_tensor(labels, torch.int32, device)})


def range_table(values, device=None) -> AttrTable:
    return AttrTable(RANGE,
                     {"value": to_tensor(values, torch.float32, device)})


def _words(bits, device) -> torch.Tensor:
    """Boolean [.., L] -> packed words; packed uint32/int32 words as is."""
    if isinstance(bits, torch.Tensor):
        if bits.dtype == torch.bool:
            return pack_bits(bits, device)
        return to_tensor(bits, torch.int32, device)
    arr = np.asarray(bits)
    if arr.dtype in (np.uint32, np.int32):
        return to_tensor(arr, torch.int32, device)
    return pack_bits(arr.astype(bool), device)


def subset_table(bits, n_bits: int, bit_weights=None,
                 device=None) -> AttrTable:
    """``bits``: packed 32-bit words [N, W] or boolean [N, L]."""
    data = {"bits": _words(bits, device)}
    if bit_weights is not None:
        data["bit_weights"] = to_tensor(bit_weights, torch.float32,
                                        data["bits"].device)
    return AttrTable(SUBSET, data, n_bits=int(n_bits))


def boolean_table(assign, n_vars: int, device=None) -> AttrTable:
    if n_vars > MAX_BOOL_VARS:
        raise ValueError(f"n_vars {n_vars} > MAX_BOOL_VARS {MAX_BOOL_VARS}")
    return AttrTable(BOOLEAN,
                     {"assign": to_tensor(assign, torch.int32, device)},
                     n_bits=int(n_vars))


def joint_table(*tables: AttrTable) -> AttrTable:
    """Join per-kind attribute tables into one composite table
    (kind ``"+"``-joined in the given order)."""
    if len(tables) < 2:
        raise ValueError("joint_table needs >= 2 component tables")
    kinds, data, n_bits, n = [], {}, 0, None
    for t in tables:
        if is_composite(t.kind):
            raise ValueError(f"components must be atomic, got {t.kind!r}")
        if t.kind in kinds:
            raise ValueError(f"duplicate component kind {t.kind!r}")
        if "bit_weights" in t.data:
            raise ValueError("bit_weights is unsupported in joint tables")
        if t.n_bits:
            if n_bits and t.n_bits != n_bits:
                raise ValueError(
                    f"bit-kind components disagree on n_bits: "
                    f"{n_bits} vs {t.n_bits}")
            n_bits = t.n_bits
        if n is None:
            n = t.n
        elif t.n != n:
            raise ValueError(f"component row counts differ: {n} vs {t.n}")
        kinds.append(t.kind)
        data.update(t.data)
    return AttrTable("+".join(kinds), data, n_bits=n_bits)


# ---------------------------------------------------------------------------
# filter batch (per-query constraints)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FilterBatch:
    """A batch of B query filters.

    data layout per kind:
      label   : {"label": int32[B]}
      range   : {"lo": f32[B], "hi": f32[B]}
      subset  : {"bits": int32[B, W]}
      boolean : {"table": f32[B, 2**L], "sat": bool[B, 2**L]}
    """
    kind: str
    data: Dict[str, torch.Tensor]
    n_bits: int = 0

    @property
    def batch(self) -> int:
        return next(iter(self.data.values())).shape[0]

    def lane(self, i: int) -> "FilterBatch":
        return FilterBatch(self.kind,
                           {k: v[i:i + 1] for k, v in self.data.items()},
                           self.n_bits)

    def take(self, ids) -> "FilterBatch":
        """The sub-batch of filter lanes at positions ``ids``."""
        dev = next(iter(self.data.values())).device
        ids = to_tensor(ids, torch.int64, dev)
        return FilterBatch(self.kind,
                           {k: v[ids] for k, v in self.data.items()},
                           self.n_bits)


def label_filters(labels, device=None) -> FilterBatch:
    return FilterBatch(LABEL, {"label": to_tensor(labels, torch.int32,
                                                  device)})


def range_filters(lo, hi, device=None) -> FilterBatch:
    return FilterBatch(RANGE, {"lo": to_tensor(lo, torch.float32, device),
                               "hi": to_tensor(hi, torch.float32, device)})


def subset_filters(bits, n_bits: int, device=None) -> FilterBatch:
    return FilterBatch(SUBSET, {"bits": _words(bits, device)},
                       n_bits=int(n_bits))


def bool_dist_table(sat: torch.Tensor, n_vars: int) -> torch.Tensor:
    """Hamming distance to the satisfying set over {0,1}^L (min-plus
    relaxation, L rounds of all single-bit flips). ``sat``: bool[..., 2**L].
    """
    L = int(n_vars)
    idx = torch.arange(1 << L, device=sat.device)
    dist = torch.where(sat, torch.tensor(0.0, device=sat.device),
                       torch.tensor(float(2 * L + 1), device=sat.device))
    flips = [idx ^ (1 << i) for i in range(L)]
    for _ in range(L):
        for f in flips:
            dist = torch.minimum(dist, dist[..., f] + 1.0)
    return dist


def boolean_filters(sat, n_vars: int, device=None) -> FilterBatch:
    """``sat``: bool[B, 2**L] truth tables of the boolean predicates."""
    sat = to_tensor(sat, torch.bool, device)
    return FilterBatch(BOOLEAN, {"table": bool_dist_table(sat, n_vars),
                                 "sat": sat}, n_bits=int(n_vars))


# ---------------------------------------------------------------------------
# filter expression trees: And / Or / Not over the four atomic leaves
# ---------------------------------------------------------------------------

class FilterExpr:
    """Base class of compound filter expressions: ``a & b``, ``a | b``,
    ``~a``. Same-op children flatten, so ``a & b & c`` is one 3-clause And.
    """

    def __and__(self, other):
        return _combine(And, self, other)

    def __rand__(self, other):
        return _combine(And, other, self)

    def __or__(self, other):
        return _combine(Or, self, other)

    def __ror__(self, other):
        return _combine(Or, other, self)

    def __invert__(self):
        if isinstance(self, Not):
            return self.child
        return Not(self)

    def __repr__(self) -> str:
        return f"FilterExpr<{describe(self)}>"

    @property
    def kind(self) -> str:
        """Structural signature, e.g. ``"(label&~range)"``."""
        raise NotImplementedError

    @property
    def batch(self) -> int:
        return self.leaves()[0].batch

    @property
    def n_bits(self) -> int:
        return max(f.n_bits for f in self.leaves())

    def leaves(self) -> list:
        """The atomic FilterBatch leaves, depth-first left-to-right."""
        raise NotImplementedError

    def _map_leaves(self, fn) -> "FilterExpr":
        raise NotImplementedError

    def lane(self, i: int) -> "FilterExpr":
        return self._map_leaves(lambda f: f.lane(i))

    def take(self, ids) -> "FilterExpr":
        return self._map_leaves(lambda f: f.take(ids))


def _coerce(x) -> FilterExpr:
    if isinstance(x, FilterExpr):
        return x
    if isinstance(x, FilterBatch):
        return Leaf(x)
    raise TypeError(f"expected FilterExpr or FilterBatch, got {type(x)!r}")


def _combine(cls, a, b) -> FilterExpr:
    kids = []
    for x in (_coerce(a), _coerce(b)):
        kids.extend(x.children if isinstance(x, cls) else (x,))
    return cls(*kids)


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Leaf(FilterExpr):
    """An atomic filter wrapped as an expression node."""
    filt: FilterBatch

    @property
    def kind(self) -> str:
        return self.filt.kind

    def leaves(self) -> list:
        return [self.filt]

    def _map_leaves(self, fn) -> "Leaf":
        return Leaf(fn(self.filt))


@dataclasses.dataclass(frozen=True, eq=False, repr=False, init=False)
class And(FilterExpr):
    """Conjunction: every clause must match."""
    children: Tuple[FilterExpr, ...]

    def __init__(self, *children):
        if len(children) == 1 and isinstance(children[0], (tuple, list)):
            children = tuple(children[0])
        if len(children) < 2:
            raise ValueError("And needs >= 2 clauses")
        object.__setattr__(self, "children",
                           tuple(_coerce(c) for c in children))

    @property
    def kind(self) -> str:
        return "(" + "&".join(c.kind for c in self.children) + ")"

    def leaves(self) -> list:
        return [f for c in self.children for f in c.leaves()]

    def _map_leaves(self, fn) -> "And":
        return And(*[c._map_leaves(fn) for c in self.children])


@dataclasses.dataclass(frozen=True, eq=False, repr=False, init=False)
class Or(FilterExpr):
    """Disjunction: at least one clause must match."""
    children: Tuple[FilterExpr, ...]

    def __init__(self, *children):
        if len(children) == 1 and isinstance(children[0], (tuple, list)):
            children = tuple(children[0])
        if len(children) < 2:
            raise ValueError("Or needs >= 2 clauses")
        object.__setattr__(self, "children",
                           tuple(_coerce(c) for c in children))

    @property
    def kind(self) -> str:
        return "(" + "|".join(c.kind for c in self.children) + ")"

    def leaves(self) -> list:
        return [f for c in self.children for f in c.leaves()]

    def _map_leaves(self, fn) -> "Or":
        return Or(*[c._map_leaves(fn) for c in self.children])


@dataclasses.dataclass(frozen=True, eq=False, repr=False, init=False)
class Not(FilterExpr):
    """Negation of a sub-expression."""
    child: FilterExpr

    def __init__(self, child):
        object.__setattr__(self, "child", _coerce(child))

    @property
    def kind(self) -> str:
        return "~" + self.child.kind

    def leaves(self) -> list:
        return self.child.leaves()

    def _map_leaves(self, fn) -> "Not":
        return Not(self.child._map_leaves(fn))


def _atleast_1d(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1) if t.dim() == 0 else t


def Label(labels, device=None) -> Leaf:
    """Expression leaf: label equality. Scalar or [B] per-query labels."""
    return Leaf(label_filters(
        _atleast_1d(to_tensor(labels, torch.int32, device))))


def Range(lo, hi, device=None) -> Leaf:
    """Expression leaf: closed numeric range [lo, hi]. Scalars or [B]."""
    lo = _atleast_1d(to_tensor(lo, torch.float32, device))
    hi = _atleast_1d(to_tensor(hi, torch.float32, lo.device))
    lo, hi = torch.broadcast_tensors(lo, hi)
    return Leaf(range_filters(lo.contiguous(), hi.contiguous()))


def Subset(bits, n_bits: Optional[int] = None, device=None) -> Leaf:
    """Expression leaf: required-tag containment. ``bits``: boolean [L] /
    [B, L] (n_bits = L) or packed 32-bit words [W] / [B, W] (n_bits
    required)."""
    packed = (bits.dtype != torch.bool if isinstance(bits, torch.Tensor)
              else np.asarray(bits).dtype in (np.uint32, np.int32))
    if not packed:
        bits = to_tensor(bits, torch.bool, device)
        if n_bits is None:
            n_bits = bits.shape[-1]
    elif n_bits is None:
        raise ValueError("n_bits is required for packed 32-bit words")
    words = _words(bits, device)
    if words.dim() == 1:
        words = words[None]
    return Leaf(subset_filters(words, n_bits))


def Boolean(sat, n_vars: Optional[int] = None, device=None) -> Leaf:
    """Expression leaf: arbitrary boolean predicate as a truth table
    ``sat`` bool [2**L] or [B, 2**L]."""
    sat = to_tensor(sat, torch.bool, device)
    if sat.dim() == 1:
        sat = sat[None]
    if n_vars is None:
        n_vars = int(sat.shape[-1]).bit_length() - 1
        if (1 << n_vars) != sat.shape[-1]:
            raise ValueError(f"truth table size {sat.shape[-1]} is not 2**L")
    return Leaf(boolean_filters(sat, n_vars))


def as_filter(filt):
    """A single-leaf expression unwraps to its FilterBatch; compound
    expressions and raw FilterBatch pass through."""
    if isinstance(filt, Leaf):
        return filt.filt
    if isinstance(filt, (FilterBatch, FilterExpr)):
        return filt
    raise TypeError(f"expected FilterExpr or FilterBatch, got {type(filt)!r}")


def n_leaves(filt) -> int:
    """Clause count: 1 for an atomic FilterBatch, #leaves for a tree."""
    return len(filt.leaves()) if isinstance(filt, FilterExpr) else 1


def filter_batch(kind: str, data, n_bits: int = 0) -> FilterBatch:
    """Deprecated raw kind-enum constructor.

    Build filters with the expression constructors (``Label``, ``Range``,
    ``Subset``, ``Boolean``) or the per-kind ``*_filters`` helpers instead.
    """
    warnings.warn(
        "filter_batch(kind, data) is deprecated; build filters with the "
        "expression constructors Label/Range/Subset/Boolean (combine with "
        "& | ~) or the *_filters helpers",
        DeprecationWarning, stacklevel=2)
    return FilterBatch(kind, {k: torch.as_tensor(v) for k, v in
                              dict(data).items()}, n_bits=int(n_bits))


def describe(filt) -> str:
    """Human-readable expression string."""
    if isinstance(filt, Leaf):
        return describe(filt.filt)
    if isinstance(filt, And):
        return "(" + " & ".join(describe(c) for c in filt.children) + ")"
    if isinstance(filt, Or):
        return "(" + " | ".join(describe(c) for c in filt.children) + ")"
    if isinstance(filt, Not):
        return "~" + describe(filt.child)
    k = filt.kind
    if k == LABEL:
        u = np.unique(filt.data["label"].cpu().numpy())
        return f"label={u[0]}" if u.size == 1 else f"label[{filt.batch}]"
    if k == RANGE:
        lo = np.unique(filt.data["lo"].cpu().numpy())
        hi = np.unique(filt.data["hi"].cpu().numpy())
        if lo.size == 1 and hi.size == 1:
            return f"range[{lo[0]:g},{hi[0]:g}]"
        return f"range[{filt.batch} lanes]"
    if k == SUBSET:
        return f"subset[{filt.n_bits}b]"
    if k == BOOLEAN:
        return f"boolean[{filt.n_bits}v]"
    return k


# ---------------------------------------------------------------------------
# exact pass/fail (the binary g(a, f)), used for recall + pre/post filtering
# ---------------------------------------------------------------------------

def _matches_atomic(filt: FilterBatch,
                    attrs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Atomic g(a_p, f_q): attrs [B, C, ...] or broadcastable [1, C, ...]."""
    k = filt.kind
    if k == LABEL:
        return attrs["label"] == filt.data["label"][:, None]
    if k == RANGE:
        v = attrs["value"]
        return (v >= filt.data["lo"][:, None]) & (v <= filt.data["hi"][:, None])
    if k == SUBSET:
        f = filt.data["bits"][:, None, :]
        return torch.all((f & ~attrs["bits"]) == 0, dim=-1)
    if k == BOOLEAN:
        a = attrs["assign"].to(torch.int64)
        a = a.expand((filt.batch,) + a.shape[1:])
        return torch.gather(filt.data["sat"], -1, a)
    raise ValueError(k)


def _eval_counted(filt, leaf_fn):
    """Short-circuit evaluation: (ok bool[B, C], evals int32[B, C]).

    ``evals`` counts leaf evaluations under left-to-right short-circuit
    semantics (an And stops at its first failing clause, an Or at its first
    match); ``ok`` itself is evaluated dense.
    """
    if isinstance(filt, FilterBatch):
        ok = leaf_fn(filt)
        return ok, torch.ones(ok.shape, dtype=torch.int32, device=ok.device)
    if isinstance(filt, Leaf):
        return _eval_counted(filt.filt, leaf_fn)
    if isinstance(filt, Not):
        ok, ev = _eval_counted(filt.child, leaf_fn)
        return ~ok, ev
    if isinstance(filt, (And, Or)):
        is_and = isinstance(filt, And)
        ok, ev = _eval_counted(filt.children[0], leaf_fn)
        for c in filt.children[1:]:
            okc, evc = _eval_counted(c, leaf_fn)
            live = ok if is_and else ~ok
            ev = ev + torch.where(live, evc, 0)
            ok = (ok & okc) if is_and else (ok | okc)
        return ok, ev
    raise TypeError(f"not a filter: {type(filt)!r}")


def matches(filt, attrs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """g(a_p, f_q) = 1 for attrs gathered to [B, C, ...] -> bool[B, C]."""
    if isinstance(filt, FilterExpr):
        return _eval_counted(filt, lambda f: _matches_atomic(f, attrs))[0]
    return _matches_atomic(filt, attrs)


def matches_counted(filt, attrs: Dict[str, torch.Tensor]):
    """(ok bool[B, C], short-circuit leaf evals int32[B, C])."""
    return _eval_counted(filt, lambda f: _matches_atomic(f, attrs))


def broadcast_rows(table: AttrTable, ids: torch.Tensor):
    """Sample-row attrs gathered once and broadcast [1, S, ...]."""
    attrs = table.gather(ids)
    return {k: (v[None] if k != "bit_weights" else v)
            for k, v in attrs.items()}


def matches_sampled(filt, table: AttrTable, ids: torch.Tensor) -> torch.Tensor:
    """Validity over a fixed sample: bool[B, S] for sample ids [S]."""
    return matches(filt, broadcast_rows(table, ids))


def onehot_words(assign: torch.Tensor, size: int) -> torch.Tensor:
    """Packed one-hot rows: bit assign[s] set in int32 words [S, size/32]."""
    W = n_words(size)
    a = assign.to(torch.int64)
    words = torch.zeros((a.shape[0], W), dtype=torch.int32,
                        device=assign.device)
    return words.scatter_(1, (a // 32)[:, None], bit_of(a % 32)[:, None])


def matches_rows(filt, table: AttrTable, ids: torch.Tensor,
                 use_kernel: bool = False, impl=None):
    """Validity + eval counts over sample rows: (bool[B, S], int32[B, S]).

    The prefilter scan's per-block evaluator. With ``use_kernel`` the
    subset/boolean leaf validity runs through the popcount kernel
    (``kernels.ops.subset_deficit``): subset passes iff the deficit |f \\ a|
    is 0; boolean packs each query's satisfying set into bitset words and
    tests membership of the point's assignment via a one-hot deficit.
    ``impl`` is the namespace providing ``subset_deficit``: ``kernels.ops``
    by default, ``kernels.ref`` to run the same scan through the plain
    version. Results are identical either way.
    """
    raw = table.gather(ids)          # [S, ...]
    attrs = {k: (v[None] if k != "bit_weights" else v)
             for k, v in raw.items()}
    if use_kernel and impl is None:
        from ..kernels import ops as impl

    def leaf_fn(f: FilterBatch):
        if use_kernel and f.kind == SUBSET:
            return impl.subset_deficit(f.data["bits"], raw["bits"]) == 0
        if use_kernel and f.kind == BOOLEAN:
            sat_w = pack_bits(f.data["sat"])                  # [B, W]
            hot = onehot_words(raw["assign"], f.data["sat"].shape[-1])
            # deficit(sat, onehot(a)) = popcount(sat) - sat[a]
            defc = impl.subset_deficit(sat_w, hot)            # [B, S]
            return defc == (popcount(sat_w)[:, None] - 1)
        return _matches_atomic(f, attrs)

    return _eval_counted(filt, leaf_fn)


def matches_all(filt, table: AttrTable) -> torch.Tensor:
    """Full validity matrix bool[B, N] (pre-filter, ground truth)."""
    return matches_sampled(filt, table, torch.arange(table.n,
                                                     device=table.device))


def match_rate(ok: torch.Tensor) -> torch.Tensor:
    """Mean of a boolean tensor over its last axis, in float32, as XLA's
    ``jnp.mean`` computes it: the count times the float32 reciprocal of the
    length, so selectivities equal the reference's bit for bit."""
    one = torch.ones((), device=ok.device)
    n = torch.full((), float(ok.shape[-1]), device=ok.device)
    return ok.to(torch.float32).sum(dim=-1) * (one / n)


def selectivity(filt, table: AttrTable) -> torch.Tensor:
    """The share of the table's rows that pass each query: float32[B]."""
    return match_rate(matches_all(filt, table))
