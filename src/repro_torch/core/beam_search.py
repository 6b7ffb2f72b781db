"""Batched GreedySearch (Algorithm 1), counterpart of
``repro.core.beam_search``.

B queries advance in lock-step. Per-query state:

  beam ids/primary/secondary/visited : the ls-slot beam, kept sorted by the
      lexicographic key (primary, secondary), so "best unvisited" is the
      first unvisited slot.
  seen : packed bitmap int32 [B, ceil(N/32)] marked at candidate
      generation (the HNSW/Vamana visited array); bits are distinct, so the
      reference's ``.at[].add`` is a ``scatter_add_``.
  vlog : ids expanded per iteration (the visited set V, consumed by
      Insert); n_dist counts distance computations.

A lane is done when every beam slot is visited; the loop stops when all
lanes are done or after ``max_iters`` expansions. An iteration leaves a done
lane's state untouched, so the host checks for "all done" only every
``CHECK_EVERY`` iterations: fewer device-to-host waits, same results.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .distances import INF, KeyFn, gathered_d2, lex_sort
from .filters import AttrTable, bit_of

CHECK_EVERY = 8


class SearchResult(NamedTuple):
    ids: torch.Tensor         # int32 [B, k]  (-1 padded)
    primary: torch.Tensor     # f32 [B, k]
    secondary: torch.Tensor   # f32 [B, k]   (squared L2)
    vlog: torch.Tensor        # int32 [B, max_iters] expanded ids, -1 holes
    n_expanded: torch.Tensor  # int32 [B]
    n_dist: torch.Tensor      # int32 [B]


class TraversalStats(NamedTuple):
    """Per-query traversal counters (``introspect=True``), computed on the
    device from tensors the loop already holds.

      hops      : beam expansions performed (== SearchResult.n_expanded)
      sat_step  : 1-based iteration at which the beam last improved (a new
                  candidate entered the kept ls slots); 0 = seeds only
      dead_ends : iterations where the lane was active but no filter-valid
                  candidate (primary == 0) entered the beam: the paper's
                  navigational dead ends, counted
    """
    hops: torch.Tensor        # int32 [B]
    sat_step: torch.Tensor    # int32 [B]
    dead_ends: torch.Tensor   # int32 [B]


def _mask_dup_within_row(ids: torch.Tensor) -> torch.Tensor:
    """True where ids[b, j] duplicates an earlier entry of the same row."""
    eq = ids[:, :, None] == ids[:, None, :]
    C = ids.shape[1]
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                  device=ids.device), diagonal=-1)
    return torch.any(eq & lower, dim=-1)


def _sort_beam(p, s, ids, vis):
    """Stable lexicographic sort of beam rows by (primary, secondary)."""
    return lex_sort(p, s, ids, vis)


def greedy_search(graph: torch.Tensor,      # int32 [N, R] (-1 sentinel)
                  xb: torch.Tensor,         # [N, d]
                  xb_norm: torch.Tensor,    # f32 [N]
                  attr: AttrTable,
                  queries: torch.Tensor,    # [B, d]
                  entry: torch.Tensor,      # int32 [S] seed vertices
                  key_fn: KeyFn,
                  *, ls: int, k: int, max_iters: int,
                  dist_fn=gathered_d2, expand_fn=None,
                  fetch_fn=None, dedup: str = "bitmap",
                  introspect: bool = False):
    """GreedySearch under a lexicographic comparator.

    ``expand_fn(p int32[B]) -> int32[B, C]`` overrides the 1-hop neighbour
    expansion; the default gathers graph[p].

    ``fetch_fn(ids, q32, q_norm) -> (d2, attrs)`` fuses the distance and
    attribute fetch into one row gather (the fused serving layout). ``ids``
    are int32 [B, C] candidate ids already clamped to >= 0; it returns d2
    f32 [B, C] and an attrs dict shaped like ``AttrTable.gather(ids)``. It
    runs for the seed batch and once per iteration, and is then the only
    place candidate rows are read.

    ``dedup``: "bitmap" = packed seen-bits over N (exact, O(N/32) state);
    "scan" = compare against beam ∪ expansion log only (no N-sized state;
    an evicted unexpanded candidate may be revisited, which costs work but
    never correctness).

    ``introspect=True`` returns ``(SearchResult, TraversalStats)``. The
    merge sort then carries one more payload, a beam (0) or candidate (1)
    tag, through the same stable two-key sort, so the kept ids and keys
    are those of the untagged sort bit for bit.
    """
    N = xb.shape[0]
    B = queries.shape[0]
    dev = queries.device
    Wn = (N + 31) // 32 if dedup == "bitmap" else 1
    q32 = queries.to(torch.float32)
    q_norm = torch.sum(q32 * q32, dim=-1)

    def _fetch(ids):
        if fetch_fn is not None:
            return fetch_fn(ids, q32, q_norm)
        return dist_fn(xb, xb_norm, ids, q32, q_norm), attr.gather(ids)

    # --- initial beam = seed set (medoid + stratified seeds) --------------
    entry = entry.to(torch.int32).reshape(-1)
    S = entry.shape[0]
    if S > ls:
        raise ValueError(f"{S} seeds do not fit a beam of {ls} slots")
    e_ids = entry[None, :].expand(B, S).contiguous()
    e_d2, e_attrs = _fetch(e_ids)
    e_p, e_s = key_fn(e_ids, e_attrs, e_d2)
    # dedup repeated seeds so beam rows stay duplicate-free
    sdup = _mask_dup_within_row(e_ids)
    e_p = torch.where(sdup, INF, e_p)
    e_s = torch.where(sdup, INF, e_s)

    beam_ids = torch.full((B, ls), -1, dtype=torch.int32, device=dev)
    beam_ids[:, :S] = e_ids
    beam_p = torch.full((B, ls), INF, device=dev)
    beam_p[:, :S] = e_p
    beam_s = torch.full((B, ls), INF, device=dev)
    beam_s[:, :S] = e_s
    beam_vis = torch.ones((B, ls), dtype=torch.bool, device=dev)
    beam_vis[:, :S] = sdup
    beam_p, beam_s, beam_ids, beam_vis = _sort_beam(beam_p, beam_s,
                                                    beam_ids, beam_vis)

    seen = torch.zeros((B, Wn), dtype=torch.int32, device=dev)
    if dedup == "bitmap":
        dup1d = _mask_dup_within_row(entry[None, :])[0]
        bitvals = torch.where(dup1d, 0, bit_of(entry % 32))
        seen.scatter_add_(1, (entry // 32).to(torch.int64)[None].expand(B, S),
                          bitvals[None].expand(B, S))

    vlog = torch.full((B, max_iters), -1, dtype=torch.int32, device=dev)
    n_expanded = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_dist = torch.ones((B,), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    if introspect:
        sat_step = torch.zeros((B,), dtype=torch.int32, device=dev)
        dead_ends = torch.zeros((B,), dtype=torch.int32, device=dev)

    for it in range(max_iters):
        if it % CHECK_EVERY == 0 and bool(beam_vis.all()):
            break
        active = ~torch.all(beam_vis, dim=1)                       # [B]
        sel = torch.argmax((~beam_vis).to(torch.uint8), dim=1)     # 1st unvis
        p = beam_ids[rows, sel]
        beam_vis[rows, sel] = beam_vis[rows, sel] | active
        vlog[:, it] = torch.where(active, p, -1)

        # --- expand out-neighbours ---------------------------------------
        pc = p.clamp_min(0)
        nbrs = graph[pc] if expand_fn is None else expand_fn(pc)  # [B, C]
        valid = (nbrs >= 0) & active[:, None]
        nbrs_c = nbrs.clamp_min(0)
        dup = _mask_dup_within_row(nbrs)
        if dedup == "bitmap":
            word = (nbrs_c // 32).to(torch.int64)
            bitv = bit_of(nbrs_c % 32)
            already = (torch.gather(seen, 1, word) & bitv) != 0
            seen.scatter_add_(1, word,
                              torch.where(valid & ~already & ~dup, bitv, 0))
        else:  # "scan": membership test vs beam ∪ expansion log
            in_beam = torch.any(nbrs[:, :, None] == beam_ids[:, None, :],
                                dim=-1)
            in_log = torch.any(nbrs[:, :, None] == vlog[:, None, :], dim=-1)
            already = in_beam | in_log
        new = valid & ~already & ~dup

        d2, c_attrs = _fetch(nbrs_c)
        cp, cs = key_fn(nbrs_c, c_attrs, d2)
        cp = torch.where(new, cp, INF)
        cs = torch.where(new, cs, INF)
        c_ids = torch.where(new, nbrs, -1)
        n_dist += torch.sum(new, dim=1, dtype=torch.int32)

        # --- merge + truncate to ls (masked candidates are visited, so
        # they never block or expand) ---------------------------------------
        merged = (torch.cat([beam_p, cp], dim=1),
                  torch.cat([beam_s, cs], dim=1),
                  torch.cat([beam_ids, c_ids], dim=1),
                  torch.cat([beam_vis, ~new], dim=1))
        if introspect:
            tag = torch.cat([torch.zeros_like(beam_ids),
                             torch.ones_like(c_ids)], dim=1)
            m_p, m_s, m_ids, m_vis, m_tag = lex_sort(*merged, tag)
            entered = (m_tag[:, :ls] == 1) & (m_ids[:, :ls] >= 0)
            improved = active & torch.any(entered, dim=1)
            valid_in = active & torch.any(entered & (m_p[:, :ls] == 0.0),
                                          dim=1)
            sat_step = torch.where(improved, it + 1, sat_step)
            dead_ends += (active & ~valid_in).to(torch.int32)
        else:
            m_p, m_s, m_ids, m_vis = _sort_beam(*merged)
        beam_p, beam_s = m_p[:, :ls], m_s[:, :ls]
        beam_ids = m_ids[:, :ls]
        beam_vis = m_vis[:, :ls].contiguous()
        n_expanded += active.to(torch.int32)

    # top-k among *visited* beam entries (Algorithm 1 line 17)
    keep = beam_vis & (beam_ids >= 0)
    fp = torch.where(keep, beam_p, INF)
    fs = torch.where(keep, beam_s, INF)
    fids = torch.where(keep, beam_ids, -1)
    fp, fs, fids = lex_sort(fp, fs, fids)
    result = SearchResult(fids[:, :k], fp[:, :k], fs[:, :k], vlog,
                          n_expanded, n_dist)
    if introspect:
        return result, TraversalStats(n_expanded, sat_step, dead_ends)
    return result
