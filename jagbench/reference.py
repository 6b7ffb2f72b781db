"""The plain reference and the comparison that decides ``correct``.

The reference is the exact filtered top-k: every query against every row
that passes its filter, squared L2 distances in float64 from the raw
float32 rows and queries the benchmark generated, in blocks of queries so
that it fits beside nothing else on the card. It imports nothing of the
program and takes nothing the program made: the filter predicate is the
kind module's ``ref_match`` over the raw attribute words or labels.

``precision="tf32"`` is the control: the same scan with the products
``q . x`` on the TF32 tensor cores (on the CPU, which has no TF32, with
both operands rounded to TF32's 10-bit mantissa first) and the distances
it serves in float32, the nearest precision below the configuration's
float32. It must come out as not correct.

``Judge`` holds every answer of a run against the reference. Per query it
reads: returned ids that are out of range, repeated, or fail the query's
filter (``bad_ids``); no valid id where some row passes (``empty``); the
largest relative gap between a returned distance and the reference's
distance of that id (``dist_gap``); on the queries the program answered
with its exact scan, the largest relative gap, rank by rank, between the
returned distances and the reference's top-k (``rank_gap``, 1.0 for a
rank left empty); and its recall@k, a returned id counting as a hit where
it passes and lies within the reference's k-th distance (ties within a
relative 1e-5, the float32 scan's rounding, count as hits). Over a whole
run, 1 minus the mean recall (``recall_miss``) is held in the cells
with a limit of their own for it: those whose graph and postfilter
routes are approximate, where ids that pass, with their true distances,
can still lie far from the query.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

# a relative gap is taken against max(d, GAP_FLOOR * (|q|^2 + |x|^2)): the
# scale at which float32 loses the norm form's digits
GAP_FLOOR = 1e-6
TIE = 1e-5
BLOCK = 256


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest even)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def _matmul_tf32(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if q.is_cuda:
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return q @ x.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    return _tf32(q) @ _tf32(x).T


class Reference:
    """The raw rows on ``device``; ``topk`` of a batch of raw queries."""

    def __init__(self, kind, data: dict, device, k: int = 10):
        self.kind, self.k, self.device = kind, k, device
        torch.backends.cuda.matmul.allow_tf32 = False
        self.x32 = torch.as_tensor(data["xb"], device=device)
        self.x64 = self.x32.double()
        self.xn64 = (self.x64 * self.x64).sum(1)
        self.xn32 = (self.x32 * self.x32).sum(1)
        self.rows = kind.ref_rows(data, device)
        self.n = int(self.x32.shape[0])

    def topk(self, queries: np.ndarray, filters: np.ndarray,
             precision: str = "f64"):
        """(ids int64 [B, k] (-1 past the matching rows), d [B, k] float64
        (inf past them), matching rows int64 [B]). ``precision="tf32"``
        returns the control's own float32 distances (as float64)."""
        ids, ds, ns = [], [], []
        for s in range(0, len(queries), BLOCK):
            q32 = torch.as_tensor(queries[s:s + BLOCK], device=self.device)
            ok = self.kind.ref_match(
                self.rows, self.kind.ref_queries(filters[s:s + BLOCK],
                                                 self.device))
            if precision == "f64":
                q64 = q32.double()
                dist = ((q64 * q64).sum(1)[:, None] + self.xn64[None, :]
                        - 2.0 * (q64 @ self.x64.T))
            elif precision == "tf32":
                dist = ((q32 * q32).sum(1)[:, None] + self.xn32[None, :]
                        - 2.0 * _matmul_tf32(q32, self.x32))
                dist = dist.clamp_min(0.0)
            else:
                raise ValueError(f"precision {precision!r}")
            dist = torch.where(ok, dist, torch.inf)
            kk = min(self.k, self.n)
            val, idx = torch.topk(dist, kk, dim=1, largest=False)
            if precision == "f64":      # the k found, exactly, in order
                xg = self.x64[idx]
                val = torch.where(torch.isinf(val), torch.inf,
                                  ((xg - q32.double()[:, None, :]) ** 2)
                                  .sum(-1))
                val, order = torch.sort(val, dim=1, stable=True)
                idx = idx.gather(1, order)
            idx = torch.where(torch.isinf(val), -1, idx)
            ids.append(idx.cpu())
            ds.append(val.double().cpu())
            ns.append(ok.sum(1).cpu())
            del dist, ok
        return (torch.cat(ids).numpy(), torch.cat(ds).numpy(),
                torch.cat(ns).numpy())


@dataclasses.dataclass
class Verdict:
    """Per-query readings of one batch's answers (numpy arrays [B])."""
    bad_ids: np.ndarray
    empty: np.ndarray
    dist_gap: np.ndarray
    rank_gap: np.ndarray       # nan where the query was not scanned
    recall: np.ndarray         # nan where no row passes the filter


class Judge:
    """Every answer of a run against the reference (see the module
    docstring)."""

    def __init__(self, ref: Reference, queries: np.ndarray,
                 filters: np.ndarray, batch: int):
        self.ref, self.batch = ref, batch
        self.queries, self.filters = queries, filters
        self.want = [ref.topk(queries[s:s + batch], filters[s:s + batch])
                     for s in range(0, len(queries), batch)]

    def judge(self, j: int, ids: np.ndarray, primary: np.ndarray,
              dist: np.ndarray, scanned: Optional[np.ndarray]) -> Verdict:
        """Readings of the answers to pool batch ``j``: ``ids`` [B, k],
        ``primary`` [B, k] (0 marks an answer that passes, as the program
        reports it), ``dist`` [B, k] its squared distances, ``scanned``
        bool [B] the queries it answered with its exact scan."""
        r, dev = self.ref, self.ref.device
        s = j * self.batch
        q64 = torch.as_tensor(self.queries[s:s + self.batch],
                              device=dev).double()
        qf = r.kind.ref_queries(self.filters[s:s + self.batch], dev)
        want_ids, want_d, n_match = self.want[j]
        ids_t = torch.as_tensor(ids.astype(np.int64), device=dev)
        valid = (ids_t >= 0) & (torch.as_tensor(primary, device=dev) == 0)
        in_range = ids_t < r.n
        safe = torch.where(valid & in_range, ids_t, 0)
        passes = r.kind.ref_match(r.rows[safe], qf)
        xg = r.x64[safe]
        true_d = ((xg - q64[:, None, :]) ** 2).sum(-1)
        qn = (q64 * q64).sum(1)
        scale = torch.maximum(true_d, GAP_FLOOR * (qn[:, None]
                                                   + r.xn64[safe]))
        got = torch.as_tensor(dist, device=dev).double()
        ok = valid & in_range
        gap = torch.where(ok, (got - true_d).abs() / scale, 0.0)
        kk = ids.shape[1]
        marked = torch.where(ok, ids_t, -1 - torch.arange(kk, device=dev))
        srt = torch.sort(marked, dim=1).values
        dups = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(1)
        bad = (valid & ~(in_range & passes)).sum(1) + dups
        n_valid = ok.sum(1)
        nm = torch.as_tensor(n_match, device=dev)
        empty = (n_valid == 0) & (nm > 0)
        n_ref = torch.clamp(nm, max=kk)
        wd = torch.as_tensor(want_d, device=dev)
        kth = wd.gather(1, (n_ref - 1).clamp_min(0)[:, None])[:, 0]
        hit = ok & passes & (true_d <= kth[:, None] * (1 + TIE))
        hits = torch.minimum(hit.sum(1), n_ref)
        recall = torch.where(n_ref > 0, hits / n_ref.clamp_min(1),
                             torch.nan)
        # rank by rank on the scanned queries: the valid answers in order
        order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices
        got_r = got.gather(1, order)
        ok_r = ok.gather(1, order)
        wi = torch.as_tensor(want_ids, device=dev).clamp_min(0)
        wscale = torch.maximum(wd, GAP_FLOOR * (qn[:, None] + r.xn64[wi]))
        ranks = torch.arange(kk, device=dev)[None, :] < n_ref[:, None]
        rgap = torch.where(ok_r, (got_r - wd).abs() / wscale, 1.0)
        rgap = torch.where(ranks, rgap, 0.0).amax(1)
        if scanned is None:
            rgap = torch.full_like(rgap, torch.nan)
        else:
            rgap = torch.where(torch.as_tensor(scanned, device=dev), rgap,
                               torch.nan)
        host = lambda t: t.cpu().numpy()
        return Verdict(host(bad), host(empty), host(gap.amax(1)),
                       host(rgap), host(recall))


def summarize(verdicts: List[Verdict], counts: List[int]) -> Dict[str, float]:
    """The numbers compared, over every answer: each verdict stands for
    ``counts[i]`` identical servings of its batch."""
    w = np.asarray(counts, np.int64)
    rank = [np.nanmax(v.rank_gap) for v in verdicts
            if not np.all(np.isnan(v.rank_gap))]
    rec = np.concatenate([np.repeat(v.recall[None], c, 0).ravel()
                          for v, c in zip(verdicts, w)])
    out = {
        "bad_ids": int(sum(int(v.bad_ids.sum()) * c
                           for v, c in zip(verdicts, w))),
        "empty_answers": int(sum(int(v.empty.sum()) * c
                                 for v, c in zip(verdicts, w))),
        "dist_gap": float(max(float(v.dist_gap.max()) for v in verdicts)),
        "recall": float(np.nanmean(rec)) if np.any(~np.isnan(rec))
        else float("nan"),
    }
    if rank:
        out["rank_gap"] = float(max(rank))
    if not np.isnan(out["recall"]):
        out["recall_miss"] = 1.0 - out["recall"]
    return out


def failed_queries(verdicts: List[Verdict], counts: List[int],
                   limits: Dict[str, float]) -> int:
    """Answers that fail a per-query check, over every serving."""
    n = 0
    for v, c in zip(verdicts, counts):
        bad = ((v.bad_ids > limits["bad_ids"]) | v.empty
               | (v.dist_gap > limits["dist_gap"])
               | (np.nan_to_num(v.rank_gap) > limits["rank_gap"]))
        n += int(bad.sum()) * c
    return n
