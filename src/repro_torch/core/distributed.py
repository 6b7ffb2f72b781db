"""Distributed JAG: shard-and-merge serving and per-shard builds over a grid
of devices (counterpart of ``repro.core.distributed``).

Every device of a row owns an independent JAG shard (vectors, sub-graph
and attributes over N / S points, the layout of production ANN services).
The mesh is a ``[P][S]`` device grid: S shards along a row, the
reference's flattened ``("data", "model")`` shard axes (``shard_axes``),
and P rows, its ``"pod"`` query axis (``query_axes``). A batch of B
queries splits into P equal slices: row p serves query rows ``[p*B/P,
(p+1)*B/P)`` on its own S shards, each shard runs the batched beam search
on the slice, and the row's per-shard top-k results are gathered on the
row's first device and merged with one stable lexicographic sort. The rows'
results come back in query order on ``grid[0][0]``. The database is
replicated over the rows (shard s of row p lives on ``grid[p][s]``), as
the reference's ``P(sx)`` spec replicates it over ``"pod"``. The bytes
moved scale with B*k, independent of N.

A mesh is given in one of three forms: a flat sequence of S devices (one
row, P = 1), a nested ``[P][S]`` sequence, or a ``launch.mesh.Mesh`` whose
``devices`` run row-major over its axes. A device may repeat
(``[[cpu] * 4] * 2`` plays the part of the reference's faked host
devices). One process drives every shard of every row: the reference's
axes live inside one ``shard_map`` program, and so does this grid.

Fault tolerance (as in the reference): a lost shard removes only its slice
of candidates until its arrays are restored; elastic scaling changes the
number of shards, each self-contained.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
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


def shard_axes(mesh) -> Tuple[str, ...]:
    """The axes the database is sharded over: ("data", "model") that
    ``mesh.axis_names`` holds."""
    return tuple(a for a in ("data", "model") if a in mesh.axis_names)


def query_axes(mesh) -> Tuple[str, ...]:
    """The axes the queries are sharded over: ("pod",) that
    ``mesh.axis_names`` holds."""
    return tuple(a for a in ("pod",) if a in mesh.axis_names)


def as_grid(mesh) -> Tuple[Tuple[torch.device, ...], ...]:
    """A mesh in any of its three forms as a ``[P][S]`` tuple of resolved
    devices. A ``launch.mesh.Mesh`` lays its devices row-major over its
    axes; its query axes make the rows and its shard axes, in
    ("data", "model") order, the shards of a row, so shard s of a row is
    the reference's shard index s."""
    if hasattr(mesh, "axis_names"):
        if mesh.devices is None:
            raise ValueError(
                f"mesh {dict(mesh.shape)} is an accounting-only mesh (its "
                f"devices are None): pass a device list or grid, or a Mesh "
                f"with devices")
        qx, sx = query_axes(mesh), shard_axes(mesh)
        other = [a for a in mesh.axis_names if a not in qx + sx]
        if other:
            raise ValueError(f"mesh axes {other} are neither query nor "
                             f"shard axes")
        devs = np.empty(len(mesh.devices), dtype=object)
        devs[:] = list(mesh.devices)
        devs = devs.reshape(mesh.sizes).transpose(
            [mesh.axis_names.index(a) for a in qx + sx])
        n_rows = int(np.prod([mesh.shape[a] for a in qx], dtype=np.int64))
        rows = devs.reshape(n_rows, -1).tolist()
    elif len(mesh) and isinstance(mesh[0], (list, tuple)):
        rows = [list(r) for r in mesh]
    else:
        rows = [list(mesh)]
    grid = tuple(as_mesh(r) for r in rows)
    if len({len(r) for r in grid}) != 1:
        raise ValueError(f"the grid's rows differ in length: "
                         f"{[len(r) for r in grid]}")
    return grid


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


def make_serve_step(mesh, cfg: ShardedServeConfig, attr_kind: str,
                    filt_kind: str, n_bits: int = 0, variant: str = "f32",
                    dedup: str = "bitmap"):
    """Returns step(graph, xb, xb_norm, attr_data, entries, queries,
    filt_data[, scale]) -> (global ids [B, k], primary, secondary), all on
    the grid's first device.

    ``mesh``: S devices, a ``[P][S]`` grid or a ``launch.mesh.Mesh`` with
    devices (see the module docstring). ``variant``: "f32" (xb as given) |
    "int8" (xb int8 codes + trailing ``scale`` f32[d]; row norms gathered)
    | "int8_reg" (int8, norms recomputed from the gathered row).
    ``dedup``: see ``beam_search.greedy_search``.

    Per-shard arguments are sequences of S tensors or stacked ``[S, ...]``
    tensors (shard s is moved to each row's device s):
      graph    int32 [S, N_loc, R] (shard-local ids)
      xb             [S, N_loc, d]
      xb_norm  f32   [S, N_loc]
      attr_data      {name: [S, N_loc, ...]}
      entries  int32 [S, n_seeds]      (per-shard entry points)
    and the queries are ``queries [B, d]`` and ``filt_data {name: [B,
    ...]}``, split over the P rows (B must divide by P). Each shard serves
    its row's B/P queries in ``max((B/P) // query_chunk, 1)`` equal chunks
    (the slice must divide into them, as the reference's reshape
    requires). Global ids count over the shards of a row, so they are the
    same in every row.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    grid = as_grid(mesh)

    def serve_row(row, db, queries, filt_data, scale):
        B = int(queries.shape[0])
        nch = max(B // cfg.query_chunk, 1)
        if B % nch:
            raise ValueError(f"a slice of {B} queries does not split into "
                             f"{nch} equal chunks")
        bc = B // nch
        sh = put_db_sharded(db, row)
        all_i, all_p, all_s = [], [], []
        for s, dev in enumerate(row):
            attr = AttrTable(attr_kind, {k: v[s] for k, v in
                                         sh["attr_data"].items()},
                             n_bits=n_bits)
            q = queries.to(dev)
            fd = {k: v.to(dev) for k, v in filt_data.items()}
            dist_fn = _shard_dist_fn(
                variant, None if scale is None else scale.to(dev))
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
            all_i.append(gids.to(row[0]))
            all_p.append(torch.cat(prim).to(row[0]))
            all_s.append(torch.cat(sec).to(row[0]))
        # merge across the row's shards: the shard-major [B, S*k] keys, one
        # stable lexicographic sort (ties go to the lower shard)
        p, s_, i = lex_sort(torch.cat(all_p, 1), torch.cat(all_s, 1),
                            torch.cat(all_i, 1))
        return i[:, :cfg.k], p[:, :cfg.k], s_[:, :cfg.k]

    def step(graph, xb, xb_norm, attr_data, entries, queries, filt_data,
             *rest):
        db = dict(graph=graph, xb=xb, xb_norm=xb_norm, attr_data=attr_data,
                  entries=entries)
        B, P = int(queries.shape[0]), len(grid)
        if B % P:
            raise ValueError(f"a batch of {B} queries does not split over "
                             f"{P} pod rows")
        bp = B // P
        outs = []
        for p, row in enumerate(grid):
            rows = slice(p * bp, (p + 1) * bp)
            out = serve_row(row, db, queries[rows],
                            {k: v[rows] for k, v in filt_data.items()},
                            rest[0] if rest else None)
            outs.append([t.to(grid[0][0]) for t in out])
        return tuple(torch.cat(ts) for ts in zip(*outs))

    return step


def make_build_step(mesh, build_cfg, attr_kind: str, n_bits: int = 0):
    """Per-shard batched Insert over the mesh (independent sub-graphs).

    step(graph, degree, xb, xb_norm, attr_data, batch_ids, entries) ->
    (graphs, degrees), each a tuple of S tensors (shard s on row 0's device
    s), with the per-shard arguments shaped as in :func:`make_serve_step`
    (``degree [S, N]``, ``batch_ids [S, B]``). ``mesh`` takes the same
    three forms. The reference's pod rows compute the same insert on
    replicated shards, so each shard is built once, on row 0's devices,
    and row 0's graphs and degrees are returned. A shard's graph and
    degree are updated in place where they already live on its device.
    """
    from .build import make_insert_step
    row = as_grid(mesh)[0]
    insert = make_insert_step(build_cfg)

    def step(graph, degree, xb, xb_norm, attr_data, batch_ids, entries):
        sh = put_db_sharded(dict(graph=graph, degree=degree, xb=xb,
                                 xb_norm=xb_norm, attr_data=attr_data,
                                 batch_ids=batch_ids, entries=entries), row)
        graphs, degrees = [], []
        for s in range(len(row)):
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
