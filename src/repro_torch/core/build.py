"""Batch-synchronous JAG construction (Insert, Algorithm 3), counterpart of
``repro.core.build``.

Points are inserted in batches of B:
  1. For every threshold t in T (or weight w): GreedySearch from the entry
     set under D_A(t) (resp. D_A^w); union the visited logs (Alg. 3 l.4-7).
     All buckets run as one search of len(T)*B lanes: lanes never interact,
     so each lane's log is the one a separate search per bucket would give.
     The searches expand through the fused [vec | norm | attr] layout, one
     row gather per expansion: the ``fused_expand`` kernel on the card,
     and on the CPU a fetch equal bit for bit to the default two gathers.
  2. Dedup/self-mask the candidate pool, keep the C best by vector distance.
  3. JointRobustPrune -> out-neighbours of each inserted point (l.8).
  4. Reverse edges (l.9-13): proposals (v -> p) are grouped by destination
     with a sort and an in-group rank and written at slot degree[v]+rank of
     a buffer with EX spare columns; destinations whose degree exceeds R
     are re-pruned in a second pass (fill factor 0.9, paper D.3).

The graph buffer is ``int32[N, R+EX]`` with -1 beyond each row's degree.
The reference's out-of-range scatters (``mode="drop"``) and clipped takes
(``mode="clip"``) are explicit masks and clamps here, and the graph and
degree buffers are updated in place.

Device memory at build batch size b: the mutual-selection test
``[b, R, b]`` is evaluated in row chunks, ``pair_d2`` is ``[b, C, C]`` f32
and the search's seen-bitmap is ``[len(T)*b, N/32]`` int32; choose
``batch_size`` so these fit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .beam_search import greedy_search
from .distances import (INF, build_threshold_key_fn, build_weight_key_fn,
                        dist_a, lex_sort, sq_norms)
from .filters import AttrTable
from .prune import joint_robust_prune, select_to_rows
from ..serve.engine import make_fetch_fn
from ..serve.layout import build_layout


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    degree: int = 32                 # R: max out-degree
    ls_build: int = 64               # l_b: build beam width
    alpha: float = 1.2
    mode: str = "threshold"          # "threshold" | "weight"
    thresholds: tuple = (float("inf"), 0.1, 0.0)  # absolute dist_A caps
    weights: tuple = (0.0, 1.0)
    batch_size: int = 128
    cand_pool: int = 192             # C: prune candidate pool size
    max_iters: int = 0               # 0 -> 2*ls_build
    ex_slots: int = 16               # EX spare adjacency columns
    ov_max: int = 256                # max overflow vertices re-pruned / batch
    fill: float = 0.9                # overflow re-prune fill factor
    n_passes: int = 2                # DiskANN-style build passes

    @property
    def iters(self) -> int:
        return self.max_iters or 2 * self.ls_build

    @property
    def row_width(self) -> int:
        return self.degree + self.ex_slots

    @property
    def bucket_vals(self):
        return self.thresholds if self.mode == "threshold" else self.weights


# ---------------------------------------------------------------------------
# candidate pool assembly
# ---------------------------------------------------------------------------

def _dedup_pool(ids: torch.Tensor, self_ids: torch.Tensor) -> torch.Tensor:
    """Mark -1 for duplicates / self / sentinel; keep first occurrence."""
    ids = torch.where(ids == self_ids[:, None], -1, ids)
    s, order = torch.sort(ids, dim=1, stable=True)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.where(dup, -1, s)
    return torch.full_like(ids, -1).scatter_(1, order, s)


def _top_c(ids: torch.Tensor, d2: torch.Tensor, c: int) -> torch.Tensor:
    """Keep the c candidates with smallest vector distance."""
    key = torch.where(ids >= 0, d2, INF)
    return lex_sort(key, None, ids)[1][:, :c]


def _pool_d2(xb, xb_norm, ids, p_vec, p_norm):
    idc = ids.clamp(0, xb.shape[0] - 1)
    rows = xb[idc].to(torch.float32)                           # [B, C, d]
    dots = torch.bmm(rows, p_vec.to(torch.float32)[:, :, None])[..., 0]
    return torch.clamp_min(xb_norm[idc] - 2.0 * dots + p_norm[:, None], 0.0)


def _pair_d2(xb, xb_norm, cc):
    cvec = xb[cc].to(torch.float32)                            # [B, C, d]
    cnorm = xb_norm[cc]
    gram = torch.bmm(cvec, cvec.transpose(1, 2))
    return torch.clamp_min(cnorm[:, :, None] + cnorm[:, None, :]
                           - 2.0 * gram, 0.0)


def _bucket_kw(cfg: "BuildConfig") -> dict:
    return (dict(thresholds=cfg.thresholds) if cfg.mode == "threshold"
            else dict(weights=cfg.weights))


# ---------------------------------------------------------------------------
# one insertion step
# ---------------------------------------------------------------------------

def make_insert_step(cfg: BuildConfig):
    """Returns insert(graph, degree, xb, xb_norm, attr, batch_ids, entry,
    fetch_fn=None), which updates ``graph`` and ``degree`` in place and
    returns them; ``fetch_fn`` is the searches' expansion fetch
    (``greedy_search``'s hook)."""

    def insert(graph, degree, xb, xb_norm, attr: AttrTable, batch_ids,
               entry, fetch_fn=None):
        B = batch_ids.shape[0]
        p_vec = xb[batch_ids]
        p_attr = attr.gather(batch_ids)

        # --- 1. every bucket's greedy search as one batch of lanes --------
        nb = len(cfg.bucket_vals)
        lane_attr = {k: (v if k == "bit_weights"
                         else v.repeat((nb,) + (1,) * (v.dim() - 1)))
                     for k, v in p_attr.items()}
        t = torch.tensor(cfg.bucket_vals, dtype=torch.float32,
                         device=xb.device).repeat_interleave(B)[:, None]
        mk = (build_threshold_key_fn if cfg.mode == "threshold"
              else build_weight_key_fn)
        res = greedy_search(graph, xb, xb_norm, attr, p_vec.repeat(nb, 1),
                            entry, mk(attr.kind, lane_attr, t),
                            ls=cfg.ls_build, k=1, max_iters=cfg.iters,
                            fetch_fn=fetch_fn)
        # bucket logs side by side, in bucket order
        pool = res.vlog.reshape(nb, B, -1).permute(1, 0, 2).reshape(B, -1)

        # --- 2. dedup + keep best C by vector distance --------------------
        pool = _dedup_pool(pool, batch_ids)
        pn = torch.sum(p_vec.to(torch.float32) ** 2, dim=-1)
        pool_d2 = _pool_d2(xb, xb_norm, pool, p_vec, pn)
        cand = _top_c(pool, pool_d2, cfg.cand_pool)            # [B, C]
        cvalid = cand >= 0
        cc = cand.clamp_min(0)
        d2_p = _pool_d2(xb, xb_norm, cc, p_vec, pn)
        da_p = dist_a(attr.kind, p_attr, attr.gather(cc))
        pair_d2 = _pair_d2(xb, xb_norm, cc)

        # --- 3. prune -> out-neighbours of p ------------------------------
        selected = joint_robust_prune(cvalid, d2_p, da_p, pair_d2,
                                      degree=cfg.degree, alpha=cfg.alpha,
                                      **_bucket_kw(cfg))
        out_rows = select_to_rows(selected, cand, d2_p, cfg.degree)
        graph[batch_ids] = torch.cat(
            [out_rows, torch.full((B, cfg.ex_slots), -1, dtype=torch.int32,
                                  device=xb.device)], dim=1)
        degree[batch_ids] = torch.sum(out_rows >= 0, dim=1, dtype=torch.int32)

        # --- 4. reverse edges, 5. overflow re-prune -----------------------
        overflow_v = _reverse_edges(graph, degree, out_rows, batch_ids, cfg)
        _overflow_reprune(graph, degree, xb, xb_norm, attr, overflow_v, cfg)
        return graph, degree

    return insert


def _mutual(out_rows: torch.Tensor, batch_ids: torch.Tensor,
            max_elems: int = 1 << 28) -> torch.Tensor:
    """mutual[b, j]: the target of proposal (b, j) is batch point c whose
    own out-row already holds batch_ids[b]. The [B, R, B] membership cube
    is evaluated in row chunks of at most ``max_elems`` elements."""
    B, R = out_rows.shape
    step = max(1, max_elems // (R * B))

    def cube(r0):
        return out_rows[r0:r0 + step, :, None] == batch_ids[None, None, :]

    M = torch.cat([torch.any(cube(r0), dim=1) for r0 in range(0, B, step)])
    MT = M.T                                                   # [c, b]
    return torch.cat([torch.any(cube(r0) & MT[r0:r0 + step, None, :], dim=-1)
                      for r0 in range(0, B, step)])


def _reverse_edges(graph, degree, out_rows, batch_ids,
                   cfg: BuildConfig) -> torch.Tensor:
    """Scatter (v -> p) proposals grouped by destination v, in place.

    Duplicate-edge guards: (a) mutual selection within the batch drops the
    (v -> p) proposal; (b) identical (v, p) pairs (padded tail batches);
    (c) proposals already present in v's row (re-insertion passes).
    Returns the overflow vertices (degree now beyond R), -1 padded.
    """
    B, R = out_rows.shape
    N = degree.shape[0]
    W = cfg.row_width
    v = out_rows.reshape(-1)
    p = batch_ids.to(torch.int32).repeat_interleave(R)
    valid = (v >= 0) & ~_mutual(out_rows, batch_ids).reshape(-1)
    v_s = torch.where(valid, v, N)                             # sentinel last
    v_s, p_s = lex_sort(v_s, p)
    dup = torch.zeros_like(v_s, dtype=torch.bool)
    dup[1:] = (v_s[1:] == v_s[:-1]) & (p_s[1:] == p_s[:-1])
    v_s = torch.where(dup, N, v_s)
    exists = torch.any(graph[v_s.clamp(max=N - 1)] == p_s[:, None], dim=1)
    v_s = torch.where(exists, N, v_s)
    v_s, p_s = lex_sort(v_s, None, p_s)
    ar = torch.arange(v_s.shape[0], dtype=torch.int32, device=v_s.device)
    is_start = torch.ones_like(v_s, dtype=torch.bool)
    is_start[1:] = v_s[1:] != v_s[:-1]
    group_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    rank = ar - group_start
    deg_v = degree[v_s.clamp(max=N - 1)]
    slot = deg_v + rank
    ok = (v_s < N) & (slot < W)
    graph[v_s[ok].long(), slot[ok].long()] = p_s[ok]
    # per-group counts at group-end positions -> new degrees
    is_end = torch.ones_like(v_s, dtype=torch.bool)
    is_end[:-1] = v_s[1:] != v_s[:-1]
    newdeg = torch.clamp(deg_v + rank + 1, max=W)
    last = is_end & (v_s < N)
    degree[v_s[last].long()] = newdeg[last]
    # overflow vertices: degree now beyond R -> need re-prune
    over = last & (newdeg > cfg.degree)
    okey = torch.where(over, ar, 2 ** 30)
    ov_pos = lex_sort(okey, None, ar)[1][:cfg.ov_max].long()
    return torch.where(over[ov_pos], v_s[ov_pos], -1)


def _overflow_reprune(graph, degree, xb, xb_norm, attr, ov: torch.Tensor,
                      cfg: BuildConfig) -> None:
    """Re-prune rows whose degree exceeded R (Alg. 3 l.11-12), in place."""
    W = cfg.row_width
    OV = ov.shape[0]
    vvalid = ov >= 0
    vc = ov.clamp_min(0).long()
    cand = graph[vc]                                           # [OV, W]
    cvalid = (cand >= 0) & vvalid[:, None]
    cand = _dedup_pool(torch.where(cvalid, cand, -1), vc.to(torch.int32))
    cvalid = cand >= 0
    cc = cand.clamp_min(0)

    p_vec = xb[vc]
    pn = xb_norm[vc]
    d2_p = _pool_d2(xb, xb_norm, cc, p_vec, pn)
    da_p = dist_a(attr.kind, attr.gather(vc), attr.gather(cc))
    pair_d2 = _pair_d2(xb, xb_norm, cc)
    selected = joint_robust_prune(cvalid, d2_p, da_p, pair_d2,
                                  degree=cfg.degree, alpha=cfg.alpha,
                                  fill=cfg.fill, **_bucket_kw(cfg))
    new_rows = select_to_rows(selected, cand, d2_p, cfg.degree)
    new_rows = torch.cat(
        [new_rows, torch.full((OV, W - cfg.degree), -1, dtype=torch.int32,
                              device=xb.device)], dim=1)
    keep = vc[vvalid]
    graph[keep] = new_rows[vvalid]
    degree[keep] = torch.sum(new_rows[vvalid] >= 0, dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the build loop
# ---------------------------------------------------------------------------

def medoid(xb: torch.Tensor) -> int:
    """Point closest to the dataset mean (entry vertex s)."""
    x = xb.to(torch.float32)
    mu = torch.mean(x, dim=0, keepdim=True)
    return int(torch.argmin(torch.sum((x - mu) ** 2, dim=-1)))


def make_seeds(xb: torch.Tensor, n_seeds: int, seed: int = 0) -> torch.Tensor:
    """Entry set = medoid + stratified random seeds (multi-seed beam init);
    the random part draws from numpy exactly as the reference does."""
    n = xb.shape[0]
    m = medoid(xb)
    if n_seeds <= 1 or n <= n_seeds:
        ids = np.asarray([m])
    else:
        rng = np.random.default_rng(seed + 7919)
        strata = np.linspace(0, n, n_seeds, endpoint=False).astype(np.int64)
        extra = (strata + rng.integers(0, max(1, n // n_seeds),
                                       n_seeds)) % n
        ids = np.unique(np.concatenate([[m], extra]))[:n_seeds]
    return torch.as_tensor(ids.astype(np.int32), device=xb.device)


def finalize_graph(graph, degree, xb, xb_norm, attr, cfg: BuildConfig):
    """Drain the overflow backlog: re-prune every row with degree > R."""
    for _ in range(64):  # bounded; each pass fixes up to ov_max rows
        over = torch.nonzero(degree > cfg.degree).reshape(-1)
        if over.numel() == 0:
            break
        chunk = torch.full((cfg.ov_max,), -1, dtype=torch.int32,
                           device=xb.device)
        m = min(over.numel(), cfg.ov_max)
        chunk[:m] = over[:m].to(torch.int32)
        _overflow_reprune(graph, degree, xb, xb_norm, attr, chunk, cfg)
    return graph, degree


def build_graph(xb: torch.Tensor, attr: AttrTable, cfg: BuildConfig,
                seed: int = 0, entry: torch.Tensor | None = None,
                verbose: bool = False):
    """Full index build on xb's device. Returns (graph int32[N, R+EX],
    degree int32[N], entry int32[S])."""
    N = xb.shape[0]
    dev = xb.device
    xb_norm = sq_norms(xb)
    if entry is None:
        entry = make_seeds(xb, n_seeds=8, seed=seed)
    graph = torch.full((N, cfg.row_width), -1, dtype=torch.int32, device=dev)
    degree = torch.zeros((N,), dtype=torch.int32, device=dev)
    insert = make_insert_step(cfg)
    fetch_fn = make_fetch_fn(build_layout(xb, attr))

    rng = np.random.default_rng(seed)
    Bsz = cfg.batch_size
    n_batches = (N + Bsz - 1) // Bsz
    for pass_i in range(cfg.n_passes):
        order = rng.permutation(N)
        for i in range(n_batches):
            ids = order[i * Bsz:(i + 1) * Bsz]
            if len(ids) < Bsz:  # pad final batch cyclically (dup-tolerant)
                ids = np.resize(ids, Bsz)
            insert(graph, degree, xb, xb_norm, attr,
                   torch.as_tensor(ids, dtype=torch.int64, device=dev),
                   entry, fetch_fn)
            if verbose and (i % 20 == 0 or i == n_batches - 1):
                print(f"  pass {pass_i + 1}/{cfg.n_passes} "
                      f"batch {i + 1}/{n_batches}", flush=True)
        finalize_graph(graph, degree, xb, xb_norm, attr, cfg)
    return graph, degree, entry
