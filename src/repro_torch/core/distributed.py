"""Distributed JAG: shard-and-merge serving and per-shard builds over a list
of devices (counterpart of ``repro.core.distributed``).

Every device of the mesh owns an independent JAG shard (vectors, sub-graph
and attributes over N / S points, the layout of production ANN services).
Queries are replicated across shards; each shard runs the batched beam
search locally, and the per-shard top-k results are gathered on the lead
device ``mesh[0]`` and merged with one stable lexicographic sort. The
bytes moved scale with B*k, independent of N.

The mesh is a sequence of S devices (``repro_torch.distributed.sharding``);
it stands for the reference's flattened ``("data", "model")`` shard axes,
so shard s of the flat list is the reference's shard index s. One process
drives every shard. The reference's ``"pod"`` axis shards the queries
across hosts; it waits with the rest of cross-host dispatch, so queries
here are always replicated.

Fault tolerance (as in the reference): a lost shard removes only its slice
of candidates until its arrays are restored; elastic scaling changes the
number of shards, each self-contained.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..distributed.sharding import as_mesh, put_db_sharded
from .beam_search import greedy_search
from .distances import gathered_d2, gathered_dot, lex_sort, query_key_fn
from .filters import AttrTable, FilterBatch

VARIANTS = ("f32", "int8", "int8_reg")


@dataclasses.dataclass(frozen=True)
class ShardedServeConfig:
    k: int = 10
    ls: int = 64
    max_iters: int = 128
    query_chunk: int = 128     # bitmap-bounded query chunking per shard


def _int8_reg_dist_fn(scale: torch.Tensor):
    """int8 distance with the row norm recomputed from the gathered row (no
    norm gather). ``gathered_dot``, not a batched product, so each query's
    bits do not depend on how many queries share its chunk."""
    def dist_fn(xq, _norm, ids, q32, q_norm):
        rows = xq[ids.clamp(0, xq.shape[0] - 1)].to(torch.float32) * scale
        d2 = (torch.sum(rows * rows, -1) - 2.0 * gathered_dot(rows, q32)
              + q_norm[:, None])
        return torch.clamp_min(d2, 0.0)
    return dist_fn


def _shard_dist_fn(variant: str, scale):
    if variant == "f32":
        return gathered_d2
    if variant == "int8":
        from .quantized import make_int8_dist_fn
        return make_int8_dist_fn(scale)
    return _int8_reg_dist_fn(scale)


def make_serve_step(mesh: Sequence, cfg: ShardedServeConfig, attr_kind: str,
                    filt_kind: str, n_bits: int = 0, variant: str = "f32",
                    dedup: str = "bitmap"):
    """Returns step(graph, xb, xb_norm, attr_data, entries, queries,
    filt_data[, scale]) -> (global ids [B, k], primary, secondary), all on
    ``mesh[0]``.

    ``variant``: "f32" (xb as given) | "int8" (xb int8 codes + trailing
    ``scale`` f32[d]; row norms gathered) | "int8_reg" (int8, norms
    recomputed from the gathered row). ``dedup``: see
    ``beam_search.greedy_search``.

    Per-shard arguments are sequences of S tensors or stacked ``[S, ...]``
    tensors (shard s is moved to ``mesh[s]``):
      graph    int32 [S, N_loc, R] (shard-local ids)
      xb             [S, N_loc, d]
      xb_norm  f32   [S, N_loc]
      attr_data      {name: [S, N_loc, ...]}
      entries  int32 [S, n_seeds]      (per-shard entry points)
    and the replicated ones are ``queries [B, d]`` and ``filt_data {name:
    [B, ...]}``. Each shard serves the batch in ``max(B // query_chunk,
    1)`` equal chunks (B must divide into them, as the reference's reshape
    requires).
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    mesh = as_mesh(mesh)

    def step(graph, xb, xb_norm, attr_data, entries, queries, filt_data,
             *rest):
        sh = put_db_sharded(dict(graph=graph, xb=xb, xb_norm=xb_norm,
                                 attr_data=attr_data, entries=entries), mesh)
        B = int(queries.shape[0])
        nch = max(B // cfg.query_chunk, 1)
        if B % nch:
            raise ValueError(f"a batch of {B} does not split into {nch} "
                             f"equal chunks")
        bc = B // nch
        all_i, all_p, all_s = [], [], []
        for s, dev in enumerate(mesh):
            attr = AttrTable(attr_kind, {k: v[s] for k, v in
                                         sh["attr_data"].items()},
                             n_bits=n_bits)
            q = queries.to(dev)
            fd = {k: v.to(dev) for k, v in filt_data.items()}
            dist_fn = _shard_dist_fn(variant,
                                     rest[0].to(dev) if rest else None)
            ids, prim, sec = [], [], []
            for c in range(nch):
                rows = slice(c * bc, (c + 1) * bc)
                filt = FilterBatch(filt_kind, {k: v[rows]
                                               for k, v in fd.items()},
                                   n_bits=n_bits)
                res = greedy_search(sh["graph"][s], sh["xb"][s],
                                    sh["xb_norm"][s], attr, q[rows],
                                    sh["entries"][s], query_key_fn(filt),
                                    ls=cfg.ls, k=cfg.k,
                                    max_iters=cfg.max_iters, dedup=dedup,
                                    dist_fn=dist_fn)
                ids.append(res.ids)
                prim.append(res.primary)
                sec.append(res.secondary)
            ids = torch.cat(ids)
            n_loc = int(sh["xb"][s].shape[0])
            gids = torch.where(ids >= 0, ids + s * n_loc, -1)
            all_i.append(gids.to(mesh[0]))
            all_p.append(torch.cat(prim).to(mesh[0]))
            all_s.append(torch.cat(sec).to(mesh[0]))
        # merge across shards: the shard-major [B, S*k] keys, one stable
        # lexicographic sort (ties go to the lower shard)
        p, s_, i = lex_sort(torch.cat(all_p, 1), torch.cat(all_s, 1),
                            torch.cat(all_i, 1))
        return i[:, :cfg.k], p[:, :cfg.k], s_[:, :cfg.k]

    return step


def make_build_step(mesh: Sequence, build_cfg, attr_kind: str,
                    n_bits: int = 0):
    """Per-shard batched Insert over the mesh (independent sub-graphs).

    step(graph, degree, xb, xb_norm, attr_data, batch_ids, entries) ->
    (graphs, degrees), each a tuple of S tensors (shard s on ``mesh[s]``),
    with the per-shard arguments shaped as in :func:`make_serve_step`
    (``degree [S, N]``, ``batch_ids [S, B]``). A shard's graph and degree
    are updated in place where they already live on its device.
    """
    from .build import make_insert_step
    mesh = as_mesh(mesh)
    insert = make_insert_step(build_cfg)

    def step(graph, degree, xb, xb_norm, attr_data, batch_ids, entries):
        sh = put_db_sharded(dict(graph=graph, degree=degree, xb=xb,
                                 xb_norm=xb_norm, attr_data=attr_data,
                                 batch_ids=batch_ids, entries=entries), mesh)
        graphs, degrees = [], []
        for s in range(len(mesh)):
            attr = AttrTable(attr_kind, {k: v[s] for k, v in
                                         sh["attr_data"].items()},
                             n_bits=n_bits)
            g, d = insert(sh["graph"][s], sh["degree"][s], sh["xb"][s],
                          sh["xb_norm"][s], attr, sh["batch_ids"][s],
                          sh["entries"][s])
            graphs.append(g)
            degrees.append(d)
        return tuple(graphs), tuple(degrees)

    return step
