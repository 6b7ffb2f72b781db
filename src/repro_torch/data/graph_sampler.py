"""Graph generators and a fanout neighbor sampler, GraphSAGE-style
(counterpart of ``repro.data.graph_sampler``).

The sampler is host-side numpy over a CSR adjacency (the standard
data-pipeline placement: sampling is control-flow heavy, the device step
is dense); the sampled subgraph is emitted with fixed shapes (padded).
numpy only, as in the reference, which gives the same arrays bit for bit
from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    feats: np.ndarray     # [N, F] float32
    edges: np.ndarray     # [E, 2] int32 (src, dst)
    labels: np.ndarray    # [N] int32
    n_classes: int

    @property
    def n(self) -> int:
        return self.feats.shape[0]


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 seed: int = 0, cluster: bool = True) -> Graph:
    """Synthetic attributed graph with homophilous clusters."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = (centers[labels] + rng.normal(size=(n_nodes, d_feat)) * 0.5
             ).astype(np.float32)
    if cluster:  # 70% intra-class edges
        intra = int(0.7 * n_edges)
        src_i = rng.integers(0, n_nodes, intra)
        # partner within same class via label-sorted permutation trick
        order = np.argsort(labels, kind="stable")
        pos = np.empty(n_nodes, np.int64)
        pos[order] = np.arange(n_nodes)
        shift = rng.integers(1, 50, intra)
        counts = np.bincount(labels, minlength=n_classes)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lab = labels[src_i]
        dst_i = order[starts[lab]
                      + (pos[src_i] - starts[lab] + shift) % counts[lab]]
        src_r = rng.integers(0, n_nodes, n_edges - intra)
        dst_r = rng.integers(0, n_nodes, n_edges - intra)
        src = np.concatenate([src_i, src_r])
        dst = np.concatenate([dst_i, dst_r])
    else:
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
    edges = np.stack([src, dst], 1).astype(np.int32)
    return Graph(feats, edges, labels, n_classes)


def batched_molecules(n_graphs: int, nodes_per: int, edges_per: int,
                      d_feat: int, n_classes: int, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """A batch of small graphs packed into one disjoint union."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    src = rng.integers(0, nodes_per, (n_graphs, edges_per))
    dst = rng.integers(0, nodes_per, (n_graphs, edges_per))
    off = (np.arange(n_graphs) * nodes_per)[:, None]
    edges = np.stack([(src + off).reshape(-1),
                      (dst + off).reshape(-1)], 1).astype(np.int32)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    return {"feats": feats, "edges": edges, "labels": labels,
            "graph_ids": np.repeat(np.arange(n_graphs), nodes_per)}


class NeighborSampler:
    """Fanout sampler over CSR adjacency; fixed-shape padded output."""

    def __init__(self, graph: Graph, fanouts: Tuple[int, ...],
                 seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)
        # CSR: incoming edges per node (dst -> srcs)
        order = np.argsort(graph.edges[:, 1], kind="stable")
        self.src_sorted = graph.edges[order, 0]
        dst_sorted = graph.edges[order, 1]
        self.indptr = np.searchsorted(dst_sorted, np.arange(graph.n + 1))

    def sample(self, seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """Returns a reindexed subgraph: seeds first, then sampled frontier.

        Output shapes are fixed by (len(seeds), fanouts): nodes padded to
        max_nodes, edges to max_edges (padding edges are self-loops on a
        dummy node so segment ops stay valid).
        """
        layers = [seeds.astype(np.int64)]
        edge_src, edge_dst = [], []
        frontier = seeds.astype(np.int64)
        for f in self.fanouts:
            starts = self.indptr[frontier]
            degs = self.indptr[frontier + 1] - starts
            take = np.minimum(degs, f)
            # sample up to f in-neighbors per frontier node
            src_list, dst_list = [], []
            for i, v in enumerate(frontier):
                if take[i] == 0:
                    continue
                cand = self.src_sorted[starts[i]:starts[i] + degs[i]]
                pick = (cand if degs[i] <= f else
                        self.rng.choice(cand, f, replace=False))
                src_list.append(pick)
                dst_list.append(np.full(len(pick), v))
            if src_list:
                s = np.concatenate(src_list)
                d = np.concatenate(dst_list)
                edge_src.append(s)
                edge_dst.append(d)
                frontier = np.unique(s)
            else:
                frontier = np.empty((0,), np.int64)
            layers.append(frontier)

        nodes = np.unique(np.concatenate(layers))
        # seeds must map to [0, len(seeds)): put them first
        rest = np.setdiff1d(nodes, seeds, assume_unique=False)
        nodes = np.concatenate([seeds, rest])
        remap = {int(v): i for i, v in enumerate(nodes)}
        if edge_src:
            es = np.concatenate(edge_src)
            ed = np.concatenate(edge_dst)
            es = np.fromiter((remap[int(v)] for v in es), np.int32,
                             len(es))
            ed = np.fromiter((remap[int(v)] for v in ed), np.int32,
                             len(ed))
        else:
            es = ed = np.empty((0,), np.int32)

        max_nodes = int(len(seeds) * np.prod(
            [f + 1 for f in self.fanouts]))
        max_edges = int(len(seeds) * np.prod(
            [max(f, 1) for f in self.fanouts]) * len(self.fanouts))
        feats = np.zeros((max_nodes, self.g.feats.shape[1]), np.float32)
        feats[:len(nodes)] = self.g.feats[nodes]
        pad_e = max_edges - len(es)
        dummy = max_nodes - 1
        edges = np.stack([
            np.concatenate([es, np.full(pad_e, dummy, np.int32)]),
            np.concatenate([ed, np.full(pad_e, dummy, np.int32)])], 1)
        return {"feats": feats, "edges": edges,
                "labels": self.g.labels[seeds].astype(np.int32),
                "label_mask": np.ones(len(seeds), np.float32),
                "n_real_nodes": np.int32(len(nodes))}
