"""Exact filtered nearest neighbors (= the Pre-Filtering baseline).

Counterpart of ``repro.core.ground_truth``. A brute-force scan over
validity-masked distances, blocked over the database: the prefilter route,
and the recall oracle. ``use_kernel=True`` scores each block with the
``gather_dist_tile`` kernel (the database padded once up front) and runs
subset/boolean validity through the ``bitset_dist`` kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .distances import INF, sq_norms
from .filters import AttrTable, matches_rows


class GroundTruth(NamedTuple):
    ids: torch.Tensor      # int32 [B, k], -1 where fewer than k valid points
    d2: torch.Tensor       # f32 [B, k]
    n_dist: torch.Tensor   # int32 [B]: #valid points scanned (Table 1 DC)
    n_feval: torch.Tensor  # int32 [B]: short-circuit filter-clause evals


def exact_filtered_knn(xb: torch.Tensor, attr: AttrTable,
                       queries: torch.Tensor, filt, k: int = 10,
                       block: int = 4096, use_kernel: bool = False,
                       impl=None) -> GroundTruth:
    """Exact top-k among filter-satisfying points, blocked scan.

    ``filt`` is an atomic FilterBatch or a compound FilterExpr, evaluated
    per block with left-to-right short-circuit accounting (``n_feval``).
    ``impl`` is the namespace of the kernel functions the ``use_kernel``
    path calls: ``kernels.ops`` by default, ``kernels.ref`` to run the same
    scan through the plain versions.
    """
    if use_kernel and impl is None:
        from ..kernels import ops as impl
    N, d = xb.shape
    B = queries.shape[0]
    dev = xb.device
    xb32 = xb.to(torch.float32)
    xn = sq_norms(xb32)
    q32 = queries.to(torch.float32)
    qn = sq_norms(q32)
    nblk = (N + block - 1) // block
    if use_kernel:
        # pad once (rows to a block multiple, d to a multiple of 8); padded
        # rows score against the zero vector and are masked by `inb`
        pad = torch.nn.functional.pad
        xb_pad = pad(xb32, (0, (-d) % 8, 0, (-N) % block)).contiguous()
        q_pad = pad(q32, (0, (-d) % 8)).contiguous()

    top_d = torch.full((B, k), INF, device=dev)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    ndist = torch.zeros((B,), dtype=torch.int32, device=dev)
    nfeval = torch.zeros((B,), dtype=torch.int32, device=dev)
    arange = torch.arange(block, dtype=torch.int32, device=dev)
    for bi in range(nblk):
        ids = bi * block + arange
        inb = ids < N
        idc = ids.clamp(max=N - 1)
        if use_kernel:
            base = torch.full((B,), bi, dtype=torch.int32, device=dev)
            d2 = impl.gather_dist_tile(xb_pad, base, q_pad, tile=block)
        else:
            xbl = xb32[idc]
            d2 = xn[idc][None, :] + qn[:, None] - 2.0 * (q32 @ xbl.T)
        # the block's attr rows are gathered once and broadcast against the
        # filter batch
        ok, ev = matches_rows(filt, attr, idc, use_kernel=use_kernel,
                              impl=impl)
        ok = ok & inb[None, :]
        d2 = torch.where(ok, torch.clamp_min(d2, 0.0), INF)
        ndist += torch.sum(ok, dim=1, dtype=torch.int32)
        nfeval += torch.sum(torch.where(inb[None, :], ev, 0), dim=1,
                            dtype=torch.int32)
        cd = torch.cat([top_d, d2], dim=1)
        ci = torch.cat([top_i, torch.where(ok, ids[None, :], -1)], dim=1)
        cd, perm = torch.sort(cd, dim=1, stable=True)
        top_d = cd[:, :k]
        top_i = ci.gather(1, perm[:, :k])
    top_i = torch.where(torch.isinf(top_d), -1, top_i)
    return GroundTruth(top_i, top_d, ndist, nfeval)
