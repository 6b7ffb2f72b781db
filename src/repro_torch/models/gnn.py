"""GCN (Kipf & Welling, arXiv:1609.02907) by segment-sum message passing
on PyTorch (counterpart of ``repro.models.gnn``).

The product A~ X W is an explicit edge gather (``index_select``) and a
scatter-add over the destinations (``index_add``, the reference's
``jax.ops.segment_sum``): plain torch, as the reference computes it
outside any kernel. ``index_add`` sums with float atomics on the card, so
its sums are allclose there, not bitwise. Full-batch training (cora,
ogbn-products), sampled minibatches from ``data.graph_sampler`` and
batched small graphs (molecule) through a graph-id segment vector.

Parameters are a ``GCN`` module, ``layers.<i>.w`` [d_in, d_out] and
``layers.<i>.b``, the reference's tree; ``params_from_jax`` carries the
reference's weights across.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .layers import (batch_to, copy_from_tree, mlp_stack,
                     softmax_cross_entropy)


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_layers: int = 2
    d_feat: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"                 # "sym": D^-1/2 A D^-1/2, "row": D^-1 A
    dtype: Any = torch.float32

    def dims(self) -> list:
        return ([self.d_feat] + [self.d_hidden] * (self.n_layers - 1)
                + [self.n_classes])

    def param_count(self) -> int:
        dims = self.dims()
        return sum(dims[i] * dims[i + 1] + dims[i + 1]
                   for i in range(len(dims) - 1))


class GCN(nn.Module):
    """The GCN's weights: one ``layers.Dense`` (``w``, ``b``) a layer."""

    def __init__(self, cfg: GCNConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = mlp_stack(cfg.dims(), generator, cfg.dtype, device)


def init_params(cfg: GCNConfig, generator: torch.Generator,
                device=None) -> GCN:
    """Random weights, the reference's scheme: ``w`` N(0, 1) / sqrt(d_in),
    ``b`` 0. ``generator`` lives on the target device. Returned frozen;
    training turns gradients on."""
    return GCN(cfg, resolve_device(device), generator).requires_grad_(False)


def param_specs(cfg: GCNConfig) -> Dict[str, Tuple[str, ...]]:
    """Each parameter name of ``GCN(cfg)`` -> the reference's logical axes
    (kernels ("feat", "feat"), biases ("feat",): replicated)."""
    return {name: ("feat", "feat") if name.endswith(".w") else ("feat",)
            for name, _ in GCN(cfg, torch.device("meta")).named_parameters()}


def params_from_jax(cfg: GCNConfig, tree, device=None) -> GCN:
    """The reference's parameter tree (``{"layers": [{"w", "b"}, ...]}`` of
    numpy arrays) as a ``GCN``, values copied as they are."""
    return copy_from_tree(GCN(cfg, resolve_device(device)), tree)


def _degree_isd(dst: torch.Tensor, n_nodes: int,
                dtype: torch.dtype) -> torch.Tensor:
    """1 / sqrt(max(in-degree, 1)) of each node, [n_nodes]."""
    deg = torch.zeros(n_nodes, dtype=dtype, device=dst.device).index_add(
        0, dst, torch.ones(dst.shape[0], dtype=dtype, device=dst.device))
    return torch.rsqrt(torch.clamp_min(deg, 1.0))


def gcn_conv(x: torch.Tensor, edges: torch.Tensor, n_nodes: int,
             norm: str = "sym",
             inv_sqrt_deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One propagation A~ x. edges int [E, 2] (src, dst); self-loops are
    the caller's choice. ``norm="sym"`` scales each message by its
    source's and the sum by its destination's 1/sqrt(degree); ``"row"``
    divides the sum by the degree (the mean). Returns [N, F].

    The gathered messages [E, F] are the largest tensor here (64.3M x 100
    float32 at ogbn-products): the source scale multiplies them in place,
    which autograd allows (the gather saves only its indices)."""
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    if inv_sqrt_deg is None:
        inv_sqrt_deg = _degree_isd(dst, n_nodes, x.dtype)
    msgs = torch.index_select(x, 0, src)
    out = x.new_zeros((n_nodes, x.shape[-1]))
    if norm == "sym":
        msgs.mul_(inv_sqrt_deg[src][:, None])
        return out.index_add(0, dst, msgs) * inv_sqrt_deg[:, None]
    # row normalization (mean aggregator)
    return out.index_add(0, dst, msgs) * (inv_sqrt_deg ** 2)[:, None]


def forward(cfg: GCNConfig, params: GCN, feats: torch.Tensor,
            edges: torch.Tensor) -> torch.Tensor:
    """feats [N, d_feat], edges int [E, 2] -> logits [N, n_classes]. The
    self-loops are added once (A~ = A + I), and the degrees counted once
    for every layer."""
    n = feats.shape[0]
    loops = torch.arange(n, dtype=edges.dtype, device=edges.device)
    edges = torch.cat([edges, torch.stack([loops, loops], 1)], dim=0)
    isd = _degree_isd(edges[:, 1].long(), n, feats.dtype)
    x = feats.to(cfg.dtype)
    for i, lw in enumerate(params.layers):
        x = gcn_conv(x, edges, n, cfg.norm, isd)
        x = x @ lw.w + lw.b
        if i < len(params.layers) - 1:
            x = torch.relu(x)
    return x


def loss_fn(cfg: GCNConfig, params: GCN,
            batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Node classification over the whole graph. batch: feats [N, F],
    edges [E, 2], labels [N], optional label_mask [N]. Returns (ce,
    {"ce", "acc"}): acc is the mean over all N nodes of correct times the
    mask, as in the reference."""
    b = batch_to(params.layers[0].w.device, batch)
    logits = forward(cfg, params, b["feats"], b["edges"])
    mask = b.get("label_mask")
    loss = softmax_cross_entropy(logits, b["labels"], mask)
    right = (torch.argmax(logits, -1) == b["labels"]).float()
    acc = torch.mean(right * (mask.float() if mask is not None else 1.0))
    return loss, {"ce": loss, "acc": acc}


def graph_loss_fn(cfg: GCNConfig, params: GCN,
                  batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Graph classification over a packed batch of small graphs (the
    molecule shape): node logits mean-pooled by ``graph_ids``, then the
    cross-entropy a graph against ``labels`` [n_graphs]."""
    b = batch_to(params.layers[0].w.device, batch)
    logits = forward(cfg, params, b["feats"], b["edges"])
    ng = b["labels"].shape[0]
    gid = b["graph_ids"].long()
    pooled = logits.new_zeros((ng, logits.shape[-1])).index_add(0, gid,
                                                                logits)
    cnt = logits.new_zeros((ng,)).index_add(
        0, gid, torch.ones(logits.shape[0], dtype=logits.dtype,
                           device=logits.device))
    pooled = pooled / torch.clamp_min(cnt, 1.0)[:, None]
    loss = softmax_cross_entropy(pooled, b["labels"])
    return loss, {"ce": loss}


def sampled_loss_fn(cfg: GCNConfig, params: GCN,
                    batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Minibatch variant over a sampled subgraph (``NeighborSampler``'s
    layout): feats [M, F] of the sampled nodes, edges [E', 2] reindexed,
    labels and label_mask of the first ``len(labels)`` seed nodes."""
    b = batch_to(params.layers[0].w.device, batch)
    logits = forward(cfg, params, b["feats"], b["edges"])
    nb = b["labels"].shape[0]
    loss = softmax_cross_entropy(logits[:nb], b["labels"],
                                 b.get("label_mask"))
    return loss, {"ce": loss}
