"""RecSys models on PyTorch (counterpart of ``repro.models.recsys``): FM,
DeepFM, Wide&Deep and DIN over one fused embedding table.

All four share one table [total_vocab, embed_dim]; per-field offsets
index into it. The interactions:
  fm         pairwise <v_i, v_j> x_i x_j by the sum-square trick
             (Rendle ICDM'10): 0.5 * ((sum v)^2 - sum v^2);
  deepfm     the FM branch beside a deep MLP over the concatenated fields;
  wide_deep  a wide linear term (a weight a feature) plus the deep MLP;
  din        target attention over the user's behaviour sequence:
             attn_mlp(h, t, h - t, h * t) -> softmax weights -> sum w h.

Parameters are a ``Recsys`` module whose names follow the reference's
tree (``table``, ``wide``, ``bias``, ``mlp.<i>.w``/``.b``,
``attn_mlp.<i>.w``/``.b``); ``params_from_jax`` carries the reference's
weights across. Everything here is plain torch, as the reference computes
it outside any kernel: ``embedding_bag``'s ``jax.ops.segment_sum``
becomes ``index_add`` (float atomics on the card, so its sums are
allclose there, not bitwise), ``jax.lax.top_k`` becomes ``torch.topk``
(the reference breaks ties toward the lower index; the card's order of
equal scores is unspecified). The reference's logical-axis constraints
have no counterpart until the port's sharding rules.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .layers import batch_to, copy_from_tree, mlp_apply, mlp_stack


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "fm"
    kind: str = "fm"                  # fm | deepfm | wide_deep | din
    n_sparse: int = 39
    embed_dim: int = 10
    total_vocab: int = 10_000_000
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    attn_mlp_dims: Tuple[int, ...] = (80, 40)   # DIN attention tower
    seq_len: int = 100                          # DIN behaviour sequence
    n_dense: int = 13                           # dense (numeric) features
    dtype: Any = torch.float32

    def vocabs(self) -> Tuple[int, ...]:
        """Per-field vocab: a Criteo-like power-law split of
        ``total_vocab`` across the fields."""
        n = self.n_sparse
        w = np.power(np.arange(1, n + 1, dtype=np.float64), -1.1)
        w = w / w.sum()
        v = np.maximum((w * self.total_vocab).astype(np.int64), 4)
        return tuple(int(x) for x in v)

    def param_count(self) -> int:
        c = sum(self.vocabs()) * self.embed_dim
        if self.kind in ("deepfm", "wide_deep"):
            dims = ([self.n_sparse * self.embed_dim + self.n_dense]
                    + list(self.mlp_dims) + [1])
            c += sum(dims[i] * dims[i + 1] + dims[i + 1]
                     for i in range(len(dims) - 1))
        if self.kind in ("fm", "deepfm", "wide_deep"):
            c += sum(self.vocabs())          # wide / first-order weights
        if self.kind == "din":
            dims = [4 * self.embed_dim] + list(self.attn_mlp_dims) + [1]
            c += sum(dims[i] * dims[i + 1] + dims[i + 1]
                     for i in range(len(dims) - 1))
            dims = ([3 * self.embed_dim] + list(self.mlp_dims) + [1])
            c += sum(dims[i] * dims[i + 1] + dims[i + 1]
                     for i in range(len(dims) - 1))
        return c


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segments: torch.Tensor, n_segments: int,
                  combine: str = "sum") -> torch.Tensor:
    """EmbeddingBag: rows = table[ids]; out[s] = sum of rows[segments == s]
    (``combine="mean"``: over max(count, 1)). table [V, D]; ids, segments
    int [K] (segments in [0, n_segments)) -> [n_segments, D]."""
    rows = table[ids.long()]
    seg = segments.long()
    out = rows.new_zeros((n_segments, rows.shape[-1])).index_add(0, seg,
                                                                 rows)
    if combine == "mean":
        cnt = rows.new_zeros((n_segments,)).index_add(
            0, seg, torch.ones_like(seg, dtype=table.dtype))
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


def field_offsets(cfg: RecsysConfig, device=None) -> torch.Tensor:
    """Each field's first row in the fused table, int64 [n_fields]."""
    v = np.asarray(cfg.vocabs(), np.int64)
    return torch.as_tensor(np.concatenate([[0], np.cumsum(v)[:-1]]),
                           device=resolve_device(device))


def lookup_fields(table: torch.Tensor, sparse_ids: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """sparse_ids int [B, F] (per-field local ids) -> [B, F, D]."""
    flat = (sparse_ids.long() + offsets[None, :]).reshape(-1)
    return table[flat].reshape(sparse_ids.shape[0], sparse_ids.shape[1], -1)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class Recsys(nn.Module):
    """One recsys model's weights: ``table`` [total, D], for
    fm/deepfm/wide_deep ``wide`` [total] and the
    scalar ``bias``, for deepfm/wide_deep the deep tower ``mlp``, for din
    the attention tower ``attn_mlp`` and ``mlp``. Kernels start empty."""

    def __init__(self, cfg: RecsysConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        total, dt = sum(cfg.vocabs()), cfg.dtype
        self.table = nn.Parameter(torch.empty(
            total, cfg.embed_dim, dtype=dt,
            device=device))
        if cfg.kind in ("fm", "deepfm", "wide_deep"):
            self.wide = nn.Parameter(torch.empty(total, dtype=dt,
                                                 device=device))
            self.bias = nn.Parameter(torch.zeros((), dtype=dt,
                                                 device=device))
        if cfg.kind in ("deepfm", "wide_deep"):
            self.mlp = mlp_stack([cfg.n_sparse * cfg.embed_dim + cfg.n_dense,
                                  *cfg.mlp_dims, 1], generator, dt, device)
        if cfg.kind == "din":
            self.attn_mlp = mlp_stack([4 * cfg.embed_dim,
                                       *cfg.attn_mlp_dims, 1],
                                      generator, dt, device)
            self.mlp = mlp_stack([3 * cfg.embed_dim, *cfg.mlp_dims, 1],
                                 generator, dt, device)
        if cfg.kind not in ("fm", "deepfm", "wide_deep", "din"):
            raise ValueError(f"kind must be fm, deepfm, wide_deep or din, "
                             f"got {cfg.kind!r}")


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device=None) -> Recsys:
    """Random weights, the reference's scheme: the table N(0, 1) * 0.01
    drawn in float32 and cast to ``cfg.dtype``, ``wide`` N(0, 1) *
    0.01, ``bias`` 0, the towers from ``layers.mlp_stack``. ``generator``
    lives on the target device (the numbers differ from jax.random's).
    Returned frozen; training turns gradients on."""
    dev = resolve_device(device)
    model = Recsys(cfg, dev, generator)
    with torch.no_grad():
        model.table.copy_(torch.randn(model.table.shape, generator=generator,
                                      device=dev) * 0.01)
        if hasattr(model, "wide"):
            model.wide.copy_(torch.randn(model.wide.shape,
                                         generator=generator, device=dev,
                                         dtype=cfg.dtype) * 0.01)
    return model.requires_grad_(False)


def params_from_jax(cfg: RecsysConfig, tree, device=None) -> Recsys:
    """The reference's parameter tree (``jax.tree.map(np.asarray,
    init_params(cfg, key)[0])``) as a ``Recsys``, values copied as they
    are."""
    return copy_from_tree(Recsys(cfg, resolve_device(device)), tree)


# ---------------------------------------------------------------------------
# interactions
# ---------------------------------------------------------------------------

def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """sum_{i<j} <v_i, v_j> by 0.5 ((sum v)^2 - sum v^2). emb [B, F, D]
    -> [B]."""
    s = torch.sum(emb, dim=1)
    s2 = torch.sum(emb * emb, dim=1)
    return 0.5 * torch.sum(s * s - s2, dim=-1)


def din_attention(hist: torch.Tensor, target: torch.Tensor,
                  attn_mlp: nn.ModuleList,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Target attention. hist [B, T, D], target [B, D], mask bool [B, T]
    -> [B, D]. A masked position's score is -1e30 (not -inf: a row with
    every position masked averages the history evenly, as the
    reference's does)."""
    B, T, D = hist.shape
    t = target[:, None, :].expand(B, T, D)
    feats = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = mlp_apply(attn_mlp, feats.reshape(B * T, -1)).reshape(B, T)
    if mask is not None:
        w = torch.where(mask, w, -1e30)
    w = torch.softmax(w, dim=-1)
    return torch.einsum("bt,btd->bd", w, hist)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def forward(cfg: RecsysConfig, params: Recsys, batch) -> torch.Tensor:
    """Logits [B] of a batch (numpy arrays or tensors, moved to the
    parameters' device): ``recsys_batch``'s keys."""
    b = batch_to(params.table.device, batch)
    if cfg.kind == "din":
        target = params.table[b["target_id"].long()]
        hist = params.table[b["hist_ids"].long()]
        user = din_attention(hist, target, params.attn_mlp,
                             b.get("hist_mask"))
        x = torch.cat([user, target, user * target], dim=-1)
        return mlp_apply(params.mlp, x)[:, 0]

    offsets = field_offsets(cfg, params.table.device)
    sparse = b["sparse_ids"].long()                          # [B, F]
    emb = lookup_fields(params.table, sparse, offsets)       # [B, F, D]
    flat_ids = (sparse + offsets[None, :]).reshape(-1)
    first = params.wide[flat_ids].reshape(sparse.shape).sum(dim=1) \
        + params.bias
    if cfg.kind == "fm":
        return first + fm_second_order(emb)
    dense = b.get("dense")
    if dense is None:
        dense = torch.zeros((sparse.shape[0], cfg.n_dense), dtype=cfg.dtype,
                            device=sparse.device)
    deep_in = torch.cat([emb.reshape(sparse.shape[0], -1), dense], dim=-1)
    deep = mlp_apply(params.mlp, deep_in)[:, 0]
    if cfg.kind == "deepfm":
        return first + fm_second_order(emb) + deep
    return first + deep                                      # wide_deep


def loss_fn(cfg: RecsysConfig, params: Recsys,
            batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean logloss in float32, in the stable form max(z, 0) - z y +
    log1p(exp(-|z|)). Returns ``(loss, {"logloss": loss})``."""
    z = forward(cfg, params, batch).float()
    y = torch.as_tensor(batch["label"], device=z.device).float()
    loss = torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))
    return loss, {"logloss": loss}


def retrieval_scores(user_vec: torch.Tensor,
                     cand_table: torch.Tensor) -> torch.Tensor:
    """Score B user vectors [B, D] against every candidate [N, D]: one
    product, [B, N]."""
    return user_vec @ cand_table.T


def retrieval_topk(user_vec: torch.Tensor, cand_table: torch.Tensor,
                   k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, ids) of the k best candidates a user, largest first."""
    return torch.topk(retrieval_scores(user_vec, cand_table), k, dim=-1)
