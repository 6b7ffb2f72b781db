"""Filter distance ``dist_F``, attribute distance ``dist_A`` and the
lexicographic comparators of JAG §3.1-3.2 (counterpart of
``repro.core.distances``).

* Vector distances are squared L2 internally; Weight-JAG takes sqrt.
* Comparator keys are pairs ``(primary, secondary)`` of float32 compared
  lexicographically (``lex_sort``: two stable sorts, secondary first).
* ``dist_F``/``dist_A`` broadcast a per-lane filter/attribute ``[B]``
  against gathered candidate attributes ``[B, C]``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .filters import (And, BOOLEAN, LABEL, Leaf, Not, Or, RANGE, SUBSET,
                      is_composite, kind_components, popc32, popcount)

INF = float("inf")


def lex_sort(prim: torch.Tensor, sec, *payload: torch.Tensor):
    """Stable lexicographic sort along the last axis by (prim, sec).

    The counterpart of ``jax.lax.sort(..., num_keys=2)``: a stable sort on
    the secondary key, then a stable sort on the primary key; rows equal in
    both keys keep their input order, so INF/-1 padding stays put. ``sec``
    may be None (one key, ``num_keys=1``). Returns the sorted keys followed
    by the payloads in the same order.
    """
    if sec is None:
        p, perm = torch.sort(prim, dim=-1, stable=True)
        return (p,) + tuple(x.gather(-1, perm) for x in payload)
    s1, i1 = torch.sort(sec, dim=-1, stable=True)
    p2, i2 = torch.sort(prim.gather(-1, i1), dim=-1, stable=True)
    perm = i1.gather(-1, i2)
    return (p2, s1.gather(-1, i2)) + tuple(x.gather(-1, perm)
                                           for x in payload)


# ---------------------------------------------------------------------------
# dist_F : how far attribute a is from satisfying filter f  (§3.1)
# ---------------------------------------------------------------------------

def dist_f(filt, attrs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """dist_F(f_q, a) for gathered candidate attrs [B, C, ...] -> f32[B, C].

    And sums its clauses, Or takes the min, Not is the binary satisfied
    indicator of its child, so ``dist_F == 0 iff matches`` on every tree.
    """
    if isinstance(filt, Leaf):
        return dist_f(filt.filt, attrs)
    if isinstance(filt, And):
        out = dist_f(filt.children[0], attrs)
        for c in filt.children[1:]:
            out = out + dist_f(c, attrs)
        return out
    if isinstance(filt, Or):
        out = dist_f(filt.children[0], attrs)
        for c in filt.children[1:]:
            out = torch.minimum(out, dist_f(c, attrs))
        return out
    if isinstance(filt, Not):
        return (dist_f(filt.child, attrs) <= 0.0).to(torch.float32)
    k = filt.kind
    if k == LABEL:
        return (attrs["label"] != filt.data["label"][:, None]).to(
            torch.float32)
    if k == RANGE:
        v = attrs["value"]
        lo = filt.data["lo"][:, None]
        hi = filt.data["hi"][:, None]
        return torch.clamp_min(lo - v, 0.0) + torch.clamp_min(v - hi, 0.0)
    if k == SUBSET:
        f = filt.data["bits"][:, None, :]
        return popcount(f & ~attrs["bits"]).to(torch.float32)  # |f \ a|
    if k == BOOLEAN:
        a = attrs["assign"].to(torch.int64)
        return torch.gather(filt.data["table"], -1, a)
    raise ValueError(k)


# ---------------------------------------------------------------------------
# dist_A : semantic proximity between two attributes  (§3.1)
# ---------------------------------------------------------------------------

def dist_a(kind: str, a_p: Dict[str, torch.Tensor],
           a_c: Dict[str, torch.Tensor]) -> torch.Tensor:
    """dist_A(a_p, a_c): base attrs [B, ...] vs candidates [B, C, ...].
    Composite kinds sum their components' distances."""
    if is_composite(kind):
        parts = [dist_a(k2, a_p, a_c) for k2 in kind_components(kind)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    if kind == LABEL:
        return (a_p["label"][:, None] != a_c["label"]).to(torch.float32)
    if kind == RANGE:
        return torch.abs(a_p["value"][:, None] - a_c["value"])
    if kind == SUBSET:
        if "bit_weights" in a_c:
            # YFCC-style weighted distance (paper D.3):
            #   dist_A = C - sum_{i in a_u ∩ a_v} log(1/p_i)
            w = a_c["bit_weights"]
            inter = a_p["bits"][:, None, :] & a_c["bits"]
            return torch.sum(w) - _weighted_popcount(inter, w)
        return popcount(a_p["bits"][:, None, :] ^ a_c["bits"]).to(
            torch.float32)
    if kind == BOOLEAN:
        x = a_p["assign"][:, None] ^ a_c["assign"]
        return popc32(x).to(torch.float32)
    raise ValueError(kind)


def _weighted_popcount(words: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum of per-bit weights over set bits. words [..., W], w [L<=32*W]."""
    W = words.shape[-1]
    L = w.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words.unsqueeze(-1) >> shifts) & 1).to(torch.float32)
    bits = bits.reshape(words.shape[:-1] + (W * 32,))[..., :L]
    return bits @ w


def capped(da: torch.Tensor, t) -> torch.Tensor:
    """Capped attribute distance max(dist_A - t, 0) (§3.2)."""
    return torch.clamp_min(da - t, 0.0)


# ---------------------------------------------------------------------------
# comparator factories: key_fn(cand_ids, cand_attrs, d2) -> (prim, sec)
# ---------------------------------------------------------------------------

KeyFn = Callable[[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor],
                 tuple]


def query_key_fn(filt) -> KeyFn:
    """D_F(q, u) = (dist_F(f_q, a_u), dist(x_q, x_u)), Algorithm 2."""
    def key_fn(ids, attrs, d2):
        del ids
        return dist_f(filt, attrs), d2
    return key_fn


def unfiltered_key_fn() -> KeyFn:
    """Plain vector-distance comparator (post-filtering)."""
    def key_fn(ids, attrs, d2):
        del ids, attrs
        return torch.zeros_like(d2), d2
    return key_fn


def hard_filter_key_fn(filt, penalty: float = 1.0) -> KeyFn:
    """Binary match/non-match comparator (the paper's trivial dist_F): a
    FilteredVamana-style traversal that prefers valid nodes but can still
    pass through invalid ones."""
    def key_fn(ids, attrs, d2):
        del ids
        return (dist_f(filt, attrs) > 0).to(torch.float32) * penalty, d2
    return key_fn


def build_threshold_key_fn(kind: str, a_p: Dict[str, torch.Tensor],
                           t) -> KeyFn:
    """D_A^t(p, u) = (max(dist_A(a_p,a_u)-t, 0), dist(x_p,x_u)), §3.2.
    ``t``: a float32 scalar, or one threshold per lane as f32[B, 1]."""
    def key_fn(ids, attrs, d2):
        del ids
        return capped(dist_a(kind, a_p, attrs), t), d2
    return key_fn


def build_weight_key_fn(kind: str, a_p: Dict[str, torch.Tensor],
                        w) -> KeyFn:
    """D_A^w(p, u) = w·dist_A + dist (Weight-JAG §3.4); secondary = d2.
    ``w``: a float32 scalar, or one weight per lane as f32[B, 1]."""
    def key_fn(ids, attrs, d2):
        del ids
        return w * dist_a(kind, a_p, attrs) + torch.sqrt(d2), d2
    return key_fn


# ---------------------------------------------------------------------------
# squared-L2 helpers
# ---------------------------------------------------------------------------

def sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.to(torch.float32) ** 2, dim=-1)


def gathered_dot(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-candidate dot products <rows[b, c], q[b]> -> f32[B, C].

    Deliberately an elementwise multiply + last-axis sum, NOT ``bmm`` or
    ``einsum``: a batched product picks its blocking per batch size, so
    row b's low-order bits would depend on how many other queries share the
    batch. Per-query dispatch regroups sub-batches and promises results
    identical to solo execution, so every gathered candidate dot goes
    through this helper.
    """
    return torch.sum(rows.to(torch.float32)
                     * q.to(torch.float32)[:, None], dim=-1)


def gathered_d2(xb: torch.Tensor, xb_norm: torch.Tensor, ids: torch.Tensor,
                q: torch.Tensor, q_norm: torch.Tensor) -> torch.Tensor:
    """Squared L2 between q[b] and xb[ids[b, c]] via gather + dot.
    xb [N, d]; ids int[B, C] (clamped into range); q [B, d] -> f32[B, C]."""
    idc = ids.clamp(0, xb.shape[0] - 1)
    dots = gathered_dot(xb[idc], q)
    return torch.clamp_min(xb_norm[idc] - 2.0 * dots + q_norm[:, None], 0.0)
