"""Architecture registry: ``--arch <id>`` resolves here (counterpart of
``repro.configs.registry``).

Each arch module defines an ``ArchSpec``; ``make_cell`` builds one (arch x
shape x mesh) cell: the step function, its arguments as tensors on a
device (the ``meta`` device by default: shapes and dtypes, no memory), the
resolved sharding spec of every argument under the mesh's rules
(``distributed.sharding``), which arguments the step updates in place, and
the cell's accounting: ``model_flops``, ``n_params``, ``flops_scale`` and
``analytic_only``. The flop formulas, the divisibility-aware batch spec
and the GNN padding by the data-axis size are the reference's, term for
term.

The reference's ``lowering`` argument (straight-line or scanned HLO for
XLA's cost and memory analyses) has no counterpart: the port has no
``scan_layers``, ``unroll_kv`` or ``kv_block``; one eager run on the meta
device checks every op (``launch/dryrun.py``). Donation becomes
``updates``: the steps update those arguments in place.

All configs come from public literature; see the per-arch module
docstrings for sources.
"""
from __future__ import annotations

import dataclasses
import importlib
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..distributed.sharding import Rules, make_rules, resolve_spec
from ..train.optimizer import init_state, opt_specs
from .shapes import GNN_SHAPES, JAG_SHAPES, LM_SHAPES, RECSYS_SHAPES


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str                      # lm | gnn | recsys | jag
    make_config: Callable[..., Any]  # (shape_name=None) -> config
    make_reduced: Callable[[], Any]  # smoke-test config
    notes: str = ""

    @property
    def shapes(self):
        return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                "recsys": RECSYS_SHAPES, "jag": JAG_SHAPES}[self.family]


_ARCH_MODULES = [
    "llama4_maverick_400b_a17b", "llama4_scout_17b_a16e", "minicpm_2b",
    "gemma_7b", "qwen3_1_7b", "gcn_cora", "deepfm", "din", "fm",
    "wide_deep", "jag_billion",
]

_REGISTRY: Dict[str, ArchSpec] = {}


def get(arch_id: str) -> ArchSpec:
    """The ``ArchSpec`` of ``arch_id``; KeyError names the known ids."""
    if not _REGISTRY:
        for m in _ARCH_MODULES:
            mod = importlib.import_module(f"{__package__}.{m}")
            _REGISTRY[mod.SPEC.id] = mod.SPEC
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> Dict[str, ArchSpec]:
    get("gcn-cora")  # force registry load
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# inputs, specs and the cell's record
# ---------------------------------------------------------------------------

def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


class _Inputs:
    """Makes a cell's input tensors on one device: empty on ``meta``, else
    random from ``seed`` (integers below ``high``, floats N(0, 1), masks
    and labels as given)."""

    def __init__(self, device: torch.device, seed: int):
        self.device = device
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

    def __call__(self, shape, dtype, high: Optional[int] = None,
                 fill: Optional[float] = None) -> torch.Tensor:
        dev = self.device
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        if fill is not None:
            return torch.full(shape, fill, dtype=dtype, device=dev)
        if high is not None:
            return torch.randint(0, high, shape, generator=self.gen,
                                 device=dev).to(dtype)
        return torch.randn(shape, generator=self.gen, device=dev).to(dtype)


def _dp(mesh):
    """The data-parallel axes present and their total size."""
    names = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    size = 1
    for a in names:
        size *= mesh.shape[a]
    return names, size


def _lead(names) -> Any:
    """A tuple of mesh axes as one binding (a name for a single axis)."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def _lead_spec(t: torch.Tensor, binding) -> tuple:
    """The leading dim bound to ``binding``, the rest replicated."""
    return (binding,) + (None,) * (t.dim() - 1) if t.dim() else ()


def _param_shardings(specs: Dict[str, tuple], params: nn.Module,
                     rules: Rules) -> Dict[str, tuple]:
    named = dict(params.named_parameters())
    return {n: resolve_spec(specs[n], named[n].shape, rules) for n in specs}


def _params(model_cls, init, cfg, dev: torch.device, seed: int,
            train: bool) -> nn.Module:
    """The model's parameters: empty on meta, else ``init`` from seed."""
    if dev.type == "meta":
        p = model_cls(cfg, dev)
    else:
        p = init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return p.requires_grad_(train)


def make_cell(arch_id: str, shape_name: str, mesh, *,
              opt_cfg=None, rule_overrides: Optional[Dict] = None,
              device="meta", seed: int = 0,
              shape_overrides: Optional[Dict] = None,
              config_overrides: Optional[Dict] = None,
              accum: int = 1) -> Dict[str, Any]:
    """Everything needed to run or account one (arch x shape x mesh) cell:

      fn             the step: ``fn(*args)``
      args           its arguments on ``device`` (meta: no memory; a real
                     device: random inputs and initialised weights from
                     ``seed``)
      specs          the resolved spec of each argument, the same tree
                     (parameters and batches by name, ``AdamWState`` with
                     ``()`` for its step)
      updates        indices of the arguments the step updates in place
                     (the reference's ``donate_argnums``)
      cfg            the model config the cell was built from, overrides
                     included (None for a JAG cell)
      rules, model_flops, n_params, flops_scale, analytic_only and, for an
      analytic-only cell, ``reason``: why its step cannot run on meta.

    ``shape_overrides`` replaces entries of the cell's shape (a cut batch,
    say), ``config_overrides`` fields of the arch's config (a perf
    variant's knobs) and ``accum`` splits a training batch into
    microbatches; the flops follow the cell as built.
    """
    from ..device import resolve_device
    spec = get(arch_id)
    if config_overrides:
        base = spec.make_config
        spec = dataclasses.replace(spec, make_config=lambda shape=None: (
            dataclasses.replace(base(shape), **config_overrides)))
    shp = dict(spec.shapes[shape_name], **(shape_overrides or {}))
    rules = make_rules(mesh, rule_overrides)
    dev = resolve_device(device)
    inputs = _Inputs(dev, seed)
    if spec.family == "lm":
        cell = _lm_cell(spec, shape_name, shp, mesh, rules, opt_cfg, dev,
                        inputs, seed, accum)
    elif spec.family == "gnn":
        cell = _gnn_cell(spec, shape_name, shp, mesh, rules, opt_cfg, dev,
                         inputs, seed)
    elif spec.family == "recsys":
        cell = _recsys_cell(spec, shape_name, shp, mesh, rules, opt_cfg,
                            dev, inputs, seed, accum)
    elif spec.family == "jag":
        cell = _jag_cell(spec, shape_name, shp, mesh, rules, dev, inputs)
    else:
        raise ValueError(spec.family)
    cell.setdefault("flops_scale", 1.0)
    cell.setdefault("analytic_only", False)
    cell.setdefault("reason", None)
    cell.setdefault("cfg", None)
    cell["rules"] = rules
    return cell


def _default_opt():
    from ..train.optimizer import OptConfig
    return OptConfig()


# --- LM ---------------------------------------------------------------------

def _lm_cell(spec, shape_name, shp, mesh, rules, opt_cfg, dev, inputs, seed,
             accum):
    from ..models import transformer as T
    from ..train.steps import make_train_step
    cfg = spec.make_config(shape_name)
    opt_cfg = opt_cfg or _default_opt()
    train = shp["kind"] == "train"
    params = _params(T.LM, T.init_params, cfg, dev, seed, train)
    p_shard = _param_shardings(T.param_specs(cfg), params, rules)
    B, S = shp["batch"], shp["seq"]
    dp_names, dsize = _dp(mesh)
    # divisibility-aware batch sharding (long_500k decodes batch=1)
    dp = _lead(dp_names) if B % dsize == 0 else None
    n_params = cfg.param_count()
    cache_axes = ("layers", "cache_batch", "cache_seq", "kv_heads",
                  "head_dim")

    if train:
        opt = init_state(params)
        batch = {"tokens": inputs((B, S + 1), torch.int64, high=cfg.vocab)}
        step = make_train_step(partial(T.loss_fn, cfg), opt_cfg, accum)
        mf = 6 * cfg.active_param_count() * B * S
        return dict(fn=step, args=(params, opt, batch),
                    specs=(p_shard, opt_specs(p_shard),
                           {"tokens": _lead_spec(batch["tokens"], dp)}),
                    updates=(0, 1), model_flops=mf, n_params=n_params,
                    cfg=cfg)

    cache = T.init_cache(cfg, B, S, dev)
    c_shard = {k: resolve_spec(cache_axes, v.shape, rules)
               for k, v in cache.items()}
    if shp["kind"] == "prefill":
        toks = inputs((B, S), torch.int64, high=cfg.vocab)
        mf = 2 * cfg.active_param_count() * B * S
        return dict(fn=partial(T.prefill, cfg), args=(params, toks, cache),
                    specs=(p_shard, _lead_spec(toks, dp), c_shard),
                    updates=(2,), model_flops=mf, n_params=n_params,
                    cfg=cfg)

    # decode: one new token a lane, the cache full up to its last position
    tok = inputs((B,), torch.int64, high=cfg.vocab)
    cur = inputs((B,), torch.int32, fill=S - 1)
    mf = 2 * cfg.active_param_count() * B  # one token per lane
    return dict(fn=partial(T.decode_step, cfg),
                args=(params, cache, tok, cur),
                specs=(p_shard, c_shard, _lead_spec(tok, dp),
                       _lead_spec(cur, dp)),
                updates=(1,), model_flops=mf, n_params=n_params,
                cfg=cfg)


# --- GNN ---------------------------------------------------------------------

def _gnn_cell(spec, shape_name, shp, mesh, rules, opt_cfg, dev, inputs,
              seed):
    from ..models import gnn as G
    from ..train.steps import make_train_step
    cfg = spec.make_config(shape_name)
    opt_cfg = opt_cfg or _default_opt()
    params = _params(G.GCN, G.init_params, cfg, dev, seed, True)
    p_shard = _param_shardings(G.param_specs(cfg), params, rules)
    opt = init_state(params)
    dp_names, dsize = _dp(mesh)
    f32, i32 = torch.float32, torch.int32

    if shp["kind"] == "sampled":
        nb = shp["batch_nodes"]
        f = shp["fanout"]
        max_nodes = _pad_to(nb * (f[0] + 1) * (f[1] + 1), 8 * dsize)
        max_edges = _pad_to(nb * (f[0] + f[0] * f[1]) * 2, 8 * dsize)
        batch = {"feats": inputs((max_nodes, shp["d_feat"]), f32),
                 "edges": inputs((max_edges, 2), i32, high=max_nodes),
                 "labels": inputs((nb,), i32, high=cfg.n_classes),
                 "label_mask": inputs((nb,), f32, fill=1.0)}
        loss = partial(G.sampled_loss_fn, cfg)
    elif shp["kind"] == "batched":
        n = shp["batch"] * shp["n_nodes"]
        e = shp["batch"] * shp["n_edges"]
        batch = {"feats": inputs((n, shp["d_feat"]), f32),
                 "edges": inputs((e, 2), i32, high=n),
                 "labels": inputs((shp["batch"],), i32, high=cfg.n_classes),
                 "graph_ids": inputs((n,), i32, high=shp["batch"])}
        loss = partial(G.graph_loss_fn, cfg)
    else:  # full graph
        n = _pad_to(shp["n_nodes"], 8 * dsize)
        e = _pad_to(shp["n_edges"], 8 * dsize)
        batch = {"feats": inputs((n, shp["d_feat"]), f32),
                 "edges": inputs((e, 2), i32, high=n),
                 "labels": inputs((n,), i32, high=cfg.n_classes),
                 "label_mask": inputs((n,), f32, fill=1.0)}
        loss = partial(G.loss_fn, cfg)

    b_shard = {k: _lead_spec(a, _lead(dp_names) if a.shape
                             and a.shape[0] % dsize == 0 else None)
               for k, a in batch.items()}
    step = make_train_step(loss, opt_cfg)
    # 2 flops/edge/feat propagation + dense layers, fwd+bwd(x3)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [
        cfg.n_classes]
    nn_ = batch["feats"].shape[0]
    ne = batch["edges"].shape[0]
    mf = 3 * sum(2 * ne * dims[i] + 2 * nn_ * dims[i] * dims[i + 1]
                 for i in range(cfg.n_layers))
    return dict(fn=step, args=(params, opt, batch),
                specs=(p_shard, opt_specs(p_shard), b_shard),
                updates=(0, 1), model_flops=mf,
                n_params=cfg.param_count(), cfg=cfg)


# --- RecSys ------------------------------------------------------------------

def _recsys_cell(spec, shape_name, shp, mesh, rules, opt_cfg, dev, inputs,
                 seed, accum):
    from ..models import recsys as R
    from ..train.steps import make_train_step
    cfg = spec.make_config(shape_name)
    opt_cfg = opt_cfg or _default_opt()
    dp = _lead(tuple(a for a in ("pod", "data") if a in mesh.axis_names))
    B = shp["batch"]
    f32, i32 = torch.float32, torch.int32

    def batch_inputs(b):
        if cfg.kind == "din":
            return {"target_id": inputs((b,), i32, high=cfg.total_vocab),
                    "hist_ids": inputs((b, cfg.seq_len), i32,
                                       high=cfg.total_vocab),
                    "hist_mask": inputs((b, cfg.seq_len), torch.bool,
                                        fill=True),
                    "label": inputs((b,), f32, high=2)}
        return {"sparse_ids": inputs((b, cfg.n_sparse), i32,
                                     high=min(cfg.vocabs())),
                "dense": inputs((b, cfg.n_dense), f32),
                "label": inputs((b,), f32, high=2)}

    if shp["kind"] in ("train", "serve"):
        train = shp["kind"] == "train"
        params = _params(R.Recsys, R.init_params, cfg, dev, seed, train)
        p_shard = _param_shardings(R.param_specs(cfg), params, rules)
        batch = batch_inputs(B)
        b_shard = {k: _lead_spec(a, dp) for k, a in batch.items()}
        if train:
            step = make_train_step(partial(R.loss_fn, cfg), opt_cfg, accum)
            return dict(fn=step, args=(params, init_state(params), batch),
                        specs=(p_shard, opt_specs(p_shard), b_shard),
                        updates=(0, 1), model_flops=3 * _recsys_fwd_flops(
                            cfg, B), n_params=cfg.param_count(), cfg=cfg)
        return dict(fn=torch.no_grad()(partial(R.forward, cfg)),
                    args=(params, batch), specs=(p_shard, b_shard),
                    updates=(), model_flops=_recsys_fwd_flops(cfg, B),
                    n_params=cfg.param_count(), cfg=cfg)

    # retrieval: 1 query x n_candidates
    nc = shp["n_candidates"]
    ncp = _pad_to(nc, 16 * 8)
    user = inputs((shp["batch"], cfg.embed_dim), f32)
    cands = inputs((ncp, cfg.embed_dim), f32)
    c_spec = resolve_spec(("candidates", "table_dim"), (ncp, cfg.embed_dim),
                          rules)
    return dict(fn=partial(R.retrieval_topk, k=100), args=(user, cands),
                specs=((None, None), c_spec), updates=(),
                model_flops=2 * shp["batch"] * ncp * cfg.embed_dim,
                n_params=ncp * cfg.embed_dim, cfg=cfg)


def _recsys_fwd_flops(cfg, B):
    f = 2 * B * cfg.n_sparse * cfg.embed_dim          # bag sums
    if cfg.kind in ("fm", "deepfm"):
        f += 4 * B * cfg.n_sparse * cfg.embed_dim     # sum-square trick
    if cfg.kind in ("deepfm", "wide_deep"):
        dims = ([cfg.n_sparse * cfg.embed_dim + cfg.n_dense]
                + list(cfg.mlp_dims) + [1])
        f += 2 * B * sum(dims[i] * dims[i + 1]
                         for i in range(len(dims) - 1))
    if cfg.kind == "din":
        dims = [4 * cfg.embed_dim] + list(cfg.attn_mlp_dims) + [1]
        f += 2 * B * cfg.seq_len * sum(dims[i] * dims[i + 1]
                                       for i in range(len(dims) - 1))
        dims = [3 * cfg.embed_dim] + list(cfg.mlp_dims) + [1]
        f += 2 * B * sum(dims[i] * dims[i + 1]
                         for i in range(len(dims) - 1))
    return f


# --- JAG ---------------------------------------------------------------------

SERVE_HOST_READ = (
    "the beam's early stop reads a value on the host every iteration "
    "(core/beam_search.py: bool(beam_vis.all())), which a meta tensor "
    "does not hold")
BUILD_HOST_READ = (
    "the build mixes loop regimes (search loops that stop on a value read "
    "on the host, the prune, one-shot sorts): no single multiplier is "
    "honest, so its compute term is model_flops alone")


def _jag_cell(spec, shape_name, shp, mesh, rules, dev, inputs):
    from ..core.build import BuildConfig
    from ..core.distributed import (ShardedServeConfig, as_grid,
                                    make_build_step, make_serve_step,
                                    query_axes, shard_axes)
    sx, qxs = shard_axes(mesh), query_axes(mesh)
    S = P = 1
    for a in sx:
        S *= mesh.shape[a]
    for a in qxs:
        P *= mesh.shape[a]
    n_loc = shp["n_local"]
    d = shp["d"]
    qx = _lead(qxs)
    Bq = shp["batch"] * P
    # the [P][S] grid: each pod row serves its `batch` queries on S shards
    grid = as_grid(mesh) if mesh.devices else [[dev] * S] * P
    shard = _lead(sx)
    f32, i32 = torch.float32, torch.int32

    if shp["kind"] == "jag_serve":
        W = shp["row_width"]
        cfgs = ShardedServeConfig(k=shp["k"], ls=shp["ls"],
                                  max_iters=shp["max_iters"],
                                  query_chunk=shp["query_chunk"])
        fn = make_serve_step(grid, cfgs, "range", "range")
        args = (inputs((S, n_loc, W), i32, high=n_loc),
                inputs((S, n_loc, d), torch.bfloat16),
                inputs((S, n_loc), f32),
                {"value": inputs((S, n_loc), f32)},
                inputs((S, shp["n_seeds"]), i32, high=n_loc),
                inputs((Bq, d), torch.bfloat16),
                {"lo": inputs((Bq,), f32), "hi": inputs((Bq,), f32)})
        specs = tuple(
            {k: _lead_spec(v, qx if i >= 5 else shard) for k, v in a.items()}
            if isinstance(a, dict) else _lead_spec(a, qx if i >= 5
                                                   else shard)
            for i, a in enumerate(args))
        # model flops: expansions x R x d per query per shard (dominant)
        mf = Bq * S * shp["max_iters"] * W * d * 2
        # the reference's HloCostAnalysis counts the (chunk x beam) loop
        # body once and scales it by the trips: the same multiplier
        nch = max((shp["batch"]) // shp["query_chunk"], 1)
        return dict(fn=fn, args=args, specs=specs, updates=(),
                    model_flops=mf, n_params=S * n_loc * (d + W),
                    flops_scale=nch * shp["max_iters"], analytic_only=True,
                    reason=SERVE_HOST_READ)

    # jag_build
    bc = BuildConfig(degree=shp["degree"], ls_build=shp["ls_build"],
                     thresholds=(float("inf"), 1000.0, 0.0),
                     cand_pool=shp["cand_pool"],
                     ex_slots=shp["ex_slots"], batch_size=shp["batch"])
    fn = make_build_step(grid, bc, "range")
    W = shp["degree"] + shp["ex_slots"]
    args = (inputs((S, n_loc, W), i32, high=n_loc),
            inputs((S, n_loc), i32, fill=0),
            inputs((S, n_loc, d), torch.bfloat16),
            inputs((S, n_loc), f32),
            {"value": inputs((S, n_loc), f32)},
            inputs((S, shp["batch"]), i32, high=n_loc),
            inputs((S, 8), i32, high=n_loc))
    specs = tuple({k: _lead_spec(v, shard) for k, v in a.items()}
                  if isinstance(a, dict) else _lead_spec(a, shard)
                  for a in args)
    mf = (shp["batch"] * S
          * (3 * 2 * shp["ls_build"] * W * d * 2              # searches
             + shp["cand_pool"] ** 2 * d * 2))                # pair d2
    return dict(fn=fn, args=args, specs=specs, updates=(0, 1),
                model_flops=mf, n_params=S * n_loc * (d + W),
                analytic_only=True, reason=BUILD_HOST_READ)
