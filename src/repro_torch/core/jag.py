"""Public JAG index API: Threshold-JAG (default) and Weight-JAG (§3.3, §3.4),
counterpart of ``repro.core.jag``.

Thresholds/weights are given as quantiles of the empirical dist_A
distribution (paper D.3) and calibrated to absolute values at build time.
Every ``search*`` entry point is a thin shim over ``serve.Executor``;
``search_auto`` adds the selectivity-adaptive routing on top.

An index lives on one device: ``build``, ``from_arrays`` and ``load`` take
``device=`` (default ``"cuda"``). ``from_arrays`` carries state across from
the reference: it turns the dict of numpy arrays that
``repro.core.jag.JAGIndex._save_arrays`` writes (the npz archive's
content) into a port index.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_tensor
from .beam_search import SearchResult
from .build import BuildConfig, build_graph, make_seeds
from .distances import dist_a, sq_norms
from .filters import AttrTable, as_filter


@dataclasses.dataclass(frozen=True)
class JAGConfig:
    degree: int = 32
    ls_build: int = 64
    alpha: float = 1.2
    mode: str = "threshold"                    # "threshold" | "weight"
    # quantiles of dist_A; 1.0 -> pure-vector edges, 0.0 -> strict-attribute
    threshold_quantiles: Tuple[float, ...] = (1.0, 0.01, 0.0)
    # weight multipliers of h = sigma_vec / sigma_attr (paper D.3)
    weight_scales: Tuple[float, ...] = (0.0, 1.0)
    batch_size: int = 128
    cand_pool: int = 192
    calib_samples: int = 512
    seed: int = 0
    ex_slots: int = 16
    ov_max: int = 256
    n_seeds: int = 8                           # multi-seed beam init


def _sample_pairs(n: int, n_samples: int, width: int, seed: int, device):
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, n, n_samples)
    ib = rng.integers(0, n, (n_samples, width))
    return (torch.as_tensor(ia, device=device),
            torch.as_tensor(ib, device=device))


def calibrate_thresholds(attr: AttrTable, quantiles: Sequence[float],
                         n_samples: int, seed: int) -> Tuple[float, ...]:
    """Absolute dist_A caps at the requested quantiles (paper D.3), from
    the same numpy-drawn sample pairs as the reference."""
    ia, ib = _sample_pairs(attr.n, n_samples, 64, seed, attr.device)
    da = dist_a(attr.kind, attr.gather(ia), attr.gather(ib))
    da = da.cpu().numpy().reshape(-1)
    return tuple(float(da.max()) + 1.0 if q >= 1.0
                 else float(np.quantile(da, q)) for q in quantiles)


def calibrate_weight_unit(xb: torch.Tensor, attr: AttrTable, n_samples: int,
                          seed: int) -> float:
    """h = sigma(dist_vec) / sigma(dist_A) over sampled pairs (paper D.3)."""
    ia, ib = _sample_pairs(attr.n, n_samples, 16, seed, attr.device)
    da = dist_a(attr.kind, attr.gather(ia), attr.gather(ib)).cpu().numpy()
    va = xb[ia].cpu().numpy().astype(np.float32)
    vb = xb[ib.reshape(-1)].cpu().numpy().astype(np.float32).reshape(
        n_samples, 16, -1)
    dv = np.sqrt(np.maximum(((va[:, None, :] - vb) ** 2).sum(-1), 0.0))
    sa = float(np.std(da)) or 1.0
    return float(np.std(dv)) / sa


def _encode_cfg(dc) -> np.ndarray:
    """Dataclass -> uint8 repr buffer (npz-safe, allow_pickle=False)."""
    return np.frombuffer(repr(dataclasses.asdict(dc)).encode(), np.uint8)


def _decode_cfg(buf) -> dict:
    """Inverse of :func:`_encode_cfg`; the bare token ``inf`` (which
    ``ast.literal_eval`` rejects) is rewritten to the overflowing literal
    ``2e308``."""
    txt = re.sub(r"\binf\b", "2e308", bytes(buf).decode())
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in ast.literal_eval(txt).items()}


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor; uint32 payloads become int32 words bit for bit."""
    a = np.array(a)                      # a writable copy torch may own
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


class JAGIndex:
    """A built Joint Attribute Graph over (vectors, attributes)."""

    # data epoch of a frozen index: never changes. The streaming layer
    # (repro_torch.stream) bumps its own on every insert and compaction,
    # and the executor's caches follow it.
    epoch: int = 0

    def __init__(self, xb: torch.Tensor, attr: AttrTable, graph, degree,
                 entry, cfg: JAGConfig, build_cfg: BuildConfig):
        self.xb = xb
        self.xb_norm = sq_norms(xb)
        self.attr = attr
        self.graph = graph
        self.degree = degree
        self.entry = entry
        self.cfg = cfg
        self.build_cfg = build_cfg
        self._executor = None                # serve.Executor, built lazily
        self._fused = {}                     # vec_dtype -> serve.FusedLayout
        self._q8 = None                      # (codes, scale, norms) cache
        self.cost_model = None               # repro_torch.cost model | None
        self.cost_metric = "us"              # routing objective: us | n_dist
        self.telemetry = None                # repro_torch.obs.Telemetry | None

    @property
    def device(self) -> torch.device:
        return self.xb.device

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, xb, attr: AttrTable, cfg: JAGConfig = JAGConfig(),
              verbose: bool = False, device=None) -> "JAGIndex":
        """Build on ``device`` (default "cuda"); ``attr`` moves there too."""
        dev = resolve_device(device)
        xb = to_tensor(xb, torch.float32, dev)
        attr = attr.to(dev)
        if cfg.mode == "threshold":
            tvals = calibrate_thresholds(attr, cfg.threshold_quantiles,
                                         cfg.calib_samples, cfg.seed)
            wvals = ()
        else:
            h = calibrate_weight_unit(xb, attr, cfg.calib_samples, cfg.seed)
            wvals = tuple(w * h for w in cfg.weight_scales)
            tvals = ()
        bcfg = BuildConfig(
            degree=cfg.degree, ls_build=cfg.ls_build, alpha=cfg.alpha,
            mode=cfg.mode, thresholds=tvals, weights=wvals,
            batch_size=cfg.batch_size, cand_pool=cfg.cand_pool,
            ex_slots=cfg.ex_slots, ov_max=cfg.ov_max)
        seeds = make_seeds(xb, cfg.n_seeds, cfg.seed)
        graph, deg, entry = build_graph(xb, attr, bcfg, seed=cfg.seed,
                                        entry=seeds, verbose=verbose)
        return cls(xb, attr, graph, deg, entry, cfg, bcfg)

    # -- serving state (serve/) ---------------------------------------------
    @property
    def executor(self):
        """The index's ``serve.Executor``, behind every search entry point."""
        if self._executor is None:
            from ..serve.executor import Executor
            self._executor = Executor(self)
        return self._executor

    def fused_layout(self, vec_dtype: str = "f32"):
        """Build (once) and return the packed [vec|norm|attr] layout."""
        if vec_dtype not in self._fused:
            from ..serve.layout import build_layout
            self._fused[vec_dtype] = build_layout(self.xb, self.attr,
                                                  vec_dtype=vec_dtype)
        return self._fused[vec_dtype]

    def quantized(self):
        """(codes int8 [N, d], scale f32 [d], dequantized norms f32 [N]),
        computed once; saved in the archive, so a loaded index never
        re-quantizes."""
        if self._q8 is None:
            from .quantized import dequant_sq_norms, quantize_int8
            codes, scale = quantize_int8(self.xb)
            self._q8 = (codes, scale, dequant_sq_norms(codes, scale))
        return self._q8

    def attach_cost_model(self, model, metric: str = "us") -> None:
        """Attach (or detach, with None) a calibrated ``repro_torch.cost``
        model: ``search_auto`` then routes each query to the argmin of
        predicted cost instead of the static thresholds, and :meth:`save`
        keeps the model in the archive. Each route's results are unchanged.
        ``metric`` is the objective: ``"us"`` (measured wall time) or
        ``"n_dist"`` (distance computations, the paper's metric)."""
        from ..cost.model import METRICS
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, "
                             f"got {metric!r}")
        self.cost_model = model
        self.cost_metric = metric

    def attach_telemetry(self, telemetry=...):
        """Attach (or detach, with None) a ``repro_torch.obs.Telemetry``;
        with no argument a default one. Returns what was attached.

        Every :meth:`search_auto` call then records one trace per query
        (band, realized route, selectivity, predicted costs, wall us,
        n_dist, n_expanded) and ticks the route counters; the executor
        reports new route keys and epoch rolls. All of it runs on the host
        after each group has finished on the device.
        """
        if telemetry is ...:
            from ..obs import Telemetry
            telemetry = Telemetry()
        self.telemetry = telemetry
        ex = self.executor
        ex.miss_hook = None if telemetry is None else telemetry.on_executor_miss
        ex.roll_hook = None if telemetry is None else telemetry.on_epoch_roll
        return telemetry

    # -- query (Algorithm 2) ------------------------------------------------
    def search(self, queries, filt, k: int = 10, ls: int = 64,
               max_iters: int = 0, layout: str = "default") -> SearchResult:
        """Filtered top-k search under D_F = (dist_F, dist_vec).
        ``layout="fused"`` expands through the packed serving layout and
        returns the same ids and keys as the default two-gather path."""
        return self.executor.graph(self._q(queries), as_filter(filt), k=k,
                                   ls=ls, max_iters=max_iters or 2 * ls,
                                   layout=layout, dtype="f32")

    def search_int8(self, queries, filt, k: int = 10, ls: int = 64,
                    max_iters: int = 0,
                    layout: str = "default") -> SearchResult:
        """Traversal over the int8 codes, then an exact re-rank of the beam
        with the f32 rows. ``layout="fused"`` packs [codes | norm | attr]
        so each expansion is one gather (``fused_expand`` on the card)."""
        return self.executor.graph(self._q(queries), as_filter(filt), k=k,
                                   ls=ls, max_iters=max_iters or 2 * ls,
                                   layout=layout, dtype="int8")

    def search_unfiltered(self, queries, k: int = 10, ls: int = 64,
                          max_iters: int = 0) -> SearchResult:
        """Pure vector-distance search (used by post-filtering)."""
        return self.executor.unfiltered(self._q(queries), k=k, ls=ls,
                                        max_iters=max_iters or 2 * ls)

    def search_auto(self, queries, filt, k: int = 10, ls: int = 64,
                    max_iters: int = 0, planner=None,
                    return_plan: bool = False, mode: str = "per_query",
                    layout: str = "default", dtype: str = "f32",
                    on_group=None):
        """Selectivity-adaptive search: plan route(s), then execute.

        A sampled ``matches()`` probe routes to the prefilter (masked exact
        scan), graph (JAG traversal) or postfilter route.
        ``mode="per_query"`` (default) bands each query and dispatches each
        route group as its own sub-batch; ``mode="batch"`` routes the whole
        batch by the median. ``return_plan=True`` returns ``(result,
        plan)``, the plan's ``realized`` field naming the executed route
        variant (``graph[fused,int8]``; a streaming index appends
        ``+delta``). ``layout``/``dtype`` select the graph route's serving
        variant in either mode.

        With a calibrated cost model attached (:meth:`attach_cost_model`)
        routes are the argmin of predicted cost (``Executor.cost_router``);
        an explicit ``planner=`` wins over the model. With telemetry
        attached (:meth:`attach_telemetry`) each group is waited for and
        timed, and the call is recorded per query; ``Telemetry(introspect=
        True)`` serves graph groups through the introspective route (same
        ids and keys, plus ``TraversalStats``), and its spans time the
        pipeline. ``on_group(group, result, stats, seconds)`` is called
        after each group has finished on the device (``stats`` None unless
        telemetry introspects).
        """
        from ..serve.dispatch import (_span, dispatch_per_query,
                                      route_descriptor, run_route)
        from ..serve.planner import (GroupPlan, PlannerConfig, plan,
                                     plan_per_query)
        filt = as_filter(filt)
        q = self._q(queries)
        cfg = planner or PlannerConfig()
        mi = max_iters or 2 * ls
        # an explicit planner= is a routing instruction: a model never
        # shadows it
        router = (None if planner is not None
                  else self.executor.cost_router(k=k, ls=ls, filt=filt))
        tel = self.telemetry
        if tel is not None and not tel.enabled:
            tel = None
        timed = [] if tel is not None else None

        def tap(g, r, st, s):
            if timed is not None:
                timed.append((g, r, st, s))
            if on_group is not None:
                on_group(g, r, st, s)
        og = tap if (timed is not None or on_group is not None) else None
        introspect = bool(getattr(tel, "introspect", False))
        spans = getattr(tel, "spans", None)
        with _span(spans, "search_auto", mode=mode, batch=int(q.shape[0])):
            if mode == "per_query":
                with _span(spans, "plan"):
                    p = plan_per_query(filt, self.attr, cfg,
                                       executor=self.executor, router=router)
                res = dispatch_per_query(self.executor, q, filt, p, k=k,
                                         ls=ls, max_iters=mi, layout=layout,
                                         dtype=dtype, on_group=og,
                                         introspect=introspect, spans=spans)
                p = p._replace(realized=tuple(
                    route_descriptor(r, layout, dtype) for r in p.routes))
            elif mode == "batch":
                with _span(spans, "plan"):
                    p = plan(filt, self.attr, cfg, executor=self.executor,
                             router=router)
                with _span(spans, f"execute:{p.route}",
                           queries=int(q.shape[0])):
                    t0 = time.perf_counter()
                    out = run_route(self.executor, p.route, q, filt, k=k,
                                    ls=ls, max_iters=mi, layout=layout,
                                    dtype=dtype, introspect=introspect)
                    res, stats = out if introspect else (out, None)
                    if og is not None:
                        if res.ids.is_cuda:
                            torch.cuda.synchronize(res.ids.device)
                        ids = np.arange(p.selectivity.size, dtype=np.int32)
                        og(GroupPlan(p.route, ids, p.batch_selectivity), res,
                           stats, time.perf_counter() - t0)
                p = p._replace(
                    realized=route_descriptor(p.route, layout, dtype))
            else:
                raise ValueError(f"mode must be 'per_query' or 'batch', "
                                 f"got {mode!r}")
        if timed:
            tel.record_call(
                self, p,
                [(g.route, route_descriptor(g.route, layout, dtype),
                  g.ids, r, st, s) for (g, r, st, s) in timed],
                k=k, ls=ls, router=router, filt=filt, mode=mode)
            # a streaming index audits after its delta merge instead
            if tel.shadow is not None and not hasattr(self, "delta_arrays"):
                tel.shadow_audit(self, q, filt, res, p, k=k)
        return (res, p) if return_plan else res

    def _q(self, queries) -> torch.Tensor:
        return to_tensor(queries, torch.float32, self.device)

    # -- multi-device serving (serve/sharded.py) ----------------------------
    def shard(self, n_shards: int, mesh=None):
        """Re-shard this index row-wise across ``n_shards`` devices, or
        the device list ``mesh`` (which may repeat a device).

        Returns a ``serve.ShardedJAGIndex`` serving the same rows behind
        the same ``search_auto`` surface; per-shard sub-graphs are rebuilt
        from this index's rows and config (a built graph's edges cross any
        row split, so an honest reshard is a rebuild). Requires N divisible
        by the shard count and, without ``mesh``, that many visible CUDA
        devices.
        """
        from ..serve.sharded import shard_index
        return shard_index(self, n_shards, mesh=mesh)

    # -- persistence ---------------------------------------------------------
    def _save_arrays(self, cost_model=..., cost_metric: str = "us") -> dict:
        """The index as a flat npz-ready dict in the reference's format
        (shared with ``repro_torch.stream``); packed fused rows are stored
        as raw uint32 bit patterns, and any computed int8 quantization
        (``q8__*``) and the cost model (``cost__*``) ride along. The model
        is the attached one unless ``cost_model`` names another (None for
        none)."""
        if cost_model is ...:
            cost_model, cost_metric = self.cost_model, self.cost_metric

        def host(t):
            return t.cpu().numpy()

        extra = {}
        for dt, lay in self._fused.items():
            extra[f"fused_{dt}__packed_bits"] = host(lay.packed).view(
                np.uint32)
            extra[f"fused_{dt}__q_scale"] = host(lay.q_scale)
            extra[f"fused_{dt}__bit_weights"] = host(lay.bit_weights)
        if self._q8 is not None:
            for name, t in zip(("codes", "scale", "norms"), self._q8):
                extra[f"q8__{name}"] = host(t)
        if cost_model is not None:
            from ..cost.registry import to_json
            extra["cost__model"] = np.frombuffer(
                to_json(cost_model).encode(), np.uint8)
            extra["cost__metric"] = cost_metric
        attr = {}
        for k, v in self.attr.data.items():
            a = host(v)
            # packed bits and boolean assignments are uint32 in the format
            attr[f"attr__{k}"] = (a.view(np.uint32) if k in ("bits", "assign")
                                  else a)
        return dict(xb=host(self.xb), graph=host(self.graph),
                    degree=host(self.degree), entry=host(self.entry),
                    attr_kind=self.attr.kind, attr_nbits=self.attr.n_bits,
                    cfg=_encode_cfg(self.cfg),
                    build_cfg=_encode_cfg(self.build_cfg), **attr, **extra)

    def save(self, path: str) -> None:
        """Persist the index (npz, the reference's archive format)."""
        np.savez_compressed(path, **self._save_arrays())

    @classmethod
    def from_arrays(cls, d, device=None) -> "JAGIndex":
        """An index from the reference's ``_save_arrays()`` dict (or a
        loaded npz mapping, the streaming archive's included), on
        ``device`` (default "cuda").

        ``cfg``/``build_cfg`` are decoded as the reference decodes them; an
        archive without ``build_cfg`` falls back to the defaults. The fused
        layouts' ``packed_bits`` (f32 and int8 lanes) are kept as raw
        32-bit words, the int8 quantization (``q8__*``) is taken as
        stored, never recomputed, and a cost model saved with the index
        (``cost__model``, ``cost__metric``) is attached, so the index routes
        as the one that was saved.
        """
        dev = resolve_device(device)
        cfg = JAGConfig(**_decode_cfg(d["cfg"]))
        bcfg = (BuildConfig(**_decode_cfg(d["build_cfg"]))
                if "build_cfg" in d else BuildConfig())
        attr = AttrTable(str(d["attr_kind"]),
                         {k[len("attr__"):]: _from_numpy(d[k], dev)
                          for k in d.keys() if k.startswith("attr__")},
                         n_bits=int(d["attr_nbits"]))
        xb = _from_numpy(d["xb"], dev).to(torch.float32)
        idx = cls(xb, attr, _from_numpy(d["graph"], dev),
                  _from_numpy(d["degree"], dev),
                  _from_numpy(d["entry"], dev).reshape(-1), cfg, bcfg)
        from ..serve.layout import FusedLayout, VEC_DTYPES
        for dt in VEC_DTYPES:
            if f"fused_{dt}__packed_bits" in d:
                packed = _from_numpy(d[f"fused_{dt}__packed_bits"], dev)
                idx._fused[dt] = FusedLayout(
                    packed.view(torch.float32),
                    _from_numpy(d[f"fused_{dt}__q_scale"], dev),
                    _from_numpy(d[f"fused_{dt}__bit_weights"], dev),
                    attr.kind, attr.n_bits, int(xb.shape[1]), dt)
        if "q8__codes" in d:
            idx._q8 = tuple(_from_numpy(d[f"q8__{name}"], dev)
                            for name in ("codes", "scale", "norms"))
        if "cost__model" in d:
            from ..cost.registry import from_json
            idx.cost_model = from_json(bytes(d["cost__model"]).decode())
            if "cost__metric" in d:
                idx.cost_metric = str(d["cost__metric"])
        return idx

    @classmethod
    def load(cls, path: str, device=None) -> "JAGIndex":
        with np.load(path, allow_pickle=False) as z:
            return cls.from_arrays(z, device=device)

    # -- stats ---------------------------------------------------------------
    def degree_stats(self):
        d = torch.sum(self.graph >= 0, dim=1).cpu().numpy()
        return dict(mean=float(d.mean()), max=int(d.max()),
                    min=int(d.min()),
                    over_budget=int((d > self.cfg.degree).sum()))
