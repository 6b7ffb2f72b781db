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
        variant in either mode. ``on_group(group, result, seconds)``
        (per_query mode) is called after each group has finished on the
        device.
        """
        from ..serve.dispatch import (dispatch_per_query, route_descriptor,
                                      run_route)
        from ..serve.planner import PlannerConfig, plan, plan_per_query
        filt = as_filter(filt)
        q = self._q(queries)
        cfg = planner or PlannerConfig()
        mi = max_iters or 2 * ls
        if mode == "per_query":
            p = plan_per_query(filt, self.attr, cfg, executor=self.executor)
            res = dispatch_per_query(self.executor, q, filt, p, k=k, ls=ls,
                                     max_iters=mi, layout=layout,
                                     dtype=dtype, on_group=on_group)
            p = p._replace(realized=tuple(
                route_descriptor(r, layout, dtype) for r in p.routes))
        elif mode == "batch":
            p = plan(filt, self.attr, cfg, executor=self.executor)
            res = run_route(self.executor, p.route, q, filt, k=k, ls=ls,
                            max_iters=mi, layout=layout, dtype=dtype)
            p = p._replace(realized=route_descriptor(p.route, layout, dtype))
        else:
            raise ValueError(f"mode must be 'per_query' or 'batch', "
                             f"got {mode!r}")
        return (res, p) if return_plan else res

    def _q(self, queries) -> torch.Tensor:
        return to_tensor(queries, torch.float32, self.device)

    # -- persistence ---------------------------------------------------------
    def _save_arrays(self) -> dict:
        """The index as a flat npz-ready dict in the reference's format
        (shared with ``repro_torch.stream``); packed fused rows are stored
        as raw uint32 bit patterns, and any computed int8 quantization rides
        along (``q8__*``)."""
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
        32-bit words, and the int8 quantization (``q8__*``) is taken as
        stored, never recomputed. An attached cost model (``cost__*``) is
        not read.
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
