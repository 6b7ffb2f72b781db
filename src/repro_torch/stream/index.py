"""StreamingJAGIndex: a mutable index over the frozen JAG graph
(counterpart of ``repro.stream.index``).

  * **base**: a built, frozen :class:`~repro_torch.core.jag.JAGIndex`; its
    graph, vectors and serving layouts never change in place.
  * **delta**: a :class:`~repro_torch.stream.delta.DeltaSegment`, vectors
    and attr rows appended in batches and scanned exactly by the
    executor's ``delta`` route (ids offset past the base).
  * **epoch**: bumped by every insert batch and every compaction. The
    executor's caches (route closures, planner probes, fused engines) are
    keyed by it, so serving state never outlives the data it was built
    from, and the planner probes the live base + delta table.

Every search merges the base result (any planner route over the graph
segment) with the delta scan into one exact top-k per query
(``serve.dispatch.merge_topk``): with an exact base route the result is
the exact filtered k-NN over the concatenated database.

Compaction is cost-driven when a calibrated ``repro_torch.cost`` model is
attached (:meth:`attach_cost_model`, or loaded with the archive): the delta
scan is a tax every search pays, so the index compacts once the predicted
tax over the next ``query_horizon`` searches reaches the predicted total
compaction cost. Without a model the delta compacts when it passes
``compact_frac`` of the base rows; ``compact_frac <= 0`` turns automatic
compaction off either way. :meth:`compact` re-runs the build's
batch-insert step (core/build.py, Algorithm 3) over the delta ids, extends
the fused f32 layout row-wise, drops the int8 state (rebuilt on next use:
its scale is global), empties the delta and bumps the epoch.
``save``/``load`` keep the delta rows, the epoch, the cost model and the
query horizon in the reference's ``cost__*`` and ``stream__*`` keys, so a
restarted server resumes mid-stream bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.beam_search import SearchResult
from ..core.build import finalize_graph, make_insert_step
from ..core.distances import sq_norms
from ..core.filters import AttrTable, as_filter
from ..core.jag import JAGConfig, JAGIndex, _from_numpy
from ..device import resolve_device
from ..serve.dispatch import _span
from .delta import DeltaSegment


class StreamingJAGIndex:
    """A live (insertable) view over a frozen JAGIndex and a delta segment.

    It has the executor-facing surface of :class:`JAGIndex` (``graph``,
    ``xb``, ``attr``, ``entry``, ``fused_layout``, ...), so
    ``serve.Executor`` runs its routes over the graph segment unchanged,
    except that ``attr`` is the merged base + delta table.
    """

    def __init__(self, base: JAGIndex, delta: Optional[DeltaSegment] = None,
                 *, epoch: int = 0, compact_frac: float = 0.25,
                 n_compactions: int = 0, query_horizon: int = 100_000):
        self.base = base
        self.delta = delta if delta is not None else DeltaSegment.for_table(
            base.attr, int(base.xb.shape[1]))
        self.epoch = int(epoch)
        self.compact_frac = float(compact_frac)
        self.n_compactions = int(n_compactions)
        # the cost model and telemetry live on the wrapper (a compaction
        # replaces .base), the model seeded from the base archive's
        self.cost_model = base.cost_model
        self.cost_metric = base.cost_metric
        self.telemetry = None
        self.query_horizon = int(query_horizon)
        self.delta_tax_us = 0.0      # predicted delta-scan us served so far
        self._last_k = 10            # most recent served k (merge-tax term)
        self._executor = None
        self._merged: Optional[Tuple[int, AttrTable]] = None

    @classmethod
    def build(cls, xb, attr: AttrTable, cfg: JAGConfig = JAGConfig(), *,
              compact_frac: float = 0.25, query_horizon: int = 100_000,
              verbose: bool = False, device=None) -> "StreamingJAGIndex":
        """Build the base graph on ``device`` (default "cuda"), then serve
        it live."""
        return cls(JAGIndex.build(xb, attr, cfg, verbose=verbose,
                                  device=device), compact_frac=compact_frac,
                   query_horizon=query_horizon)

    # -- executor-facing surface (graph segment + live attr table) ---------
    @property
    def xb(self):
        return self.base.xb

    @property
    def xb_norm(self):
        return self.base.xb_norm

    @property
    def graph(self):
        return self.base.graph

    @property
    def degree(self):
        return self.base.degree

    @property
    def entry(self):
        return self.base.entry

    @property
    def cfg(self):
        return self.base.cfg

    @property
    def build_cfg(self):
        return self.base.build_cfg

    @property
    def device(self) -> torch.device:
        return self.base.device

    _q = JAGIndex._q

    @property
    def attr(self) -> AttrTable:
        """The live attribute table, base rows then delta rows, cached per
        epoch: base ids index the same rows as in the frozen table, and the
        planner's probe samples all ``n`` live rows."""
        if self.delta.n == 0:
            return self.base.attr
        if self._merged is None or self._merged[0] != self.epoch:
            _, dattr = self.delta.device()
            self._merged = (self.epoch, self.base.attr.append(dattr))
        return self._merged[1]

    @property
    def n(self) -> int:
        return int(self.base.xb.shape[0]) + self.delta.n

    def fused_layout(self, vec_dtype: str = "f32"):
        return self.base.fused_layout(vec_dtype)

    def quantized(self):
        return self.base.quantized()

    @property
    def executor(self):
        """This index's epoch-aware ``serve.Executor`` (not the base's: it
        must see the live attr table and the streaming epoch)."""
        if self._executor is None:
            from ..serve.executor import Executor
            self._executor = Executor(self)
        return self._executor

    def delta_arrays(self) -> Tuple[torch.Tensor, AttrTable, int]:
        """(delta vectors, delta attr table, id offset) for the delta
        route."""
        xv, dattr = self.delta.device()
        return xv, dattr, int(self.base.xb.shape[0])

    # -- cost model (routing and the compaction break-even) ----------------
    def attach_cost_model(self, model, metric: str = "us") -> None:
        """Attach (or detach, with None) a calibrated model on the wrapper:
        ``search_auto`` routes by predicted cost (see
        ``JAGIndex.attach_cost_model``) and compaction fires at the
        delta-tax break-even instead of ``compact_frac``."""
        JAGIndex.attach_cost_model(self, model, metric)

    def attach_telemetry(self, telemetry=...):
        """Attach (or detach) telemetry on the wrapper's executor, where
        the streaming epoch and caches live (see
        ``JAGIndex.attach_telemetry``); compactions and delta scans tick
        the same registry."""
        return JAGIndex.attach_telemetry(self, telemetry)

    def compaction_break_even(self, k: Optional[int] = None
                              ) -> Optional[Tuple[float, float, bool]]:
        """(delta tax us/query, compaction total us, past break-even) under
        the attached model, or None when it covers no delta and compact
        curve.

        The delta scan (+ merge) is a tax every search pays; the predicted
        tax over the next ``query_horizon`` searches against the predicted
        one-off compaction cost is the trigger. ``k`` sizes the merge term;
        it defaults to the most recently served k.
        """
        model = self.cost_model
        if model is None or not model.covers(("delta", "compact")):
            return None
        if self.delta.n == 0:
            return (0.0, 0.0, False)
        from ..cost.model import delta_scan_tax
        n, d = int(self.base.xb.shape[0]), int(self.base.xb.shape[1])
        tax = delta_scan_tax(model, n=n, d=d,
                             k=self._last_k if k is None else int(k),
                             delta_n=self.delta.n)
        cost = model.predict("compact",
                             dict(delta_n=self.delta.n, n=n, d=d))
        return (tax, cost, tax * self.query_horizon >= cost)

    # -- streaming writes --------------------------------------------------
    def _should_compact(self) -> bool:
        """The cost break-even when calibrated, else ``compact_frac``;
        ``compact_frac <= 0`` (auto-compaction off) wins over both."""
        if self.compact_frac <= 0:
            return False
        be = self.compaction_break_even()
        if be is not None:
            return be[2]
        return self.delta.n > self.compact_frac * self.base.xb.shape[0]

    def insert(self, vectors, attrs: AttrTable, *,
               auto_compact: bool = True) -> dict:
        """Append a batch of (vectors, attr rows) to the delta and bump the
        epoch; no graph work happens until compaction, which the batch
        triggers when :meth:`_should_compact` says so (with
        ``auto_compact``). Returns n_added, n_total, epoch, delta_rows and
        compacted."""
        before = self.delta.n
        n_added = self.delta.append(vectors, attrs) - before
        self.epoch += 1
        compacted = False
        if auto_compact and self._should_compact():
            compacted = self.compact()
        return dict(n_added=n_added, n_total=self.n, epoch=self.epoch,
                    delta_rows=self.delta.n, compacted=compacted)

    def compact(self, verbose: bool = False) -> bool:
        """Fold the delta into the graph; empty the delta, bump the epoch.

        ``build_cfg.n_passes`` passes of the build's insert step over the
        delta ids only (the last batch padded cyclically, as ``np.resize``
        pads it), each followed by ``finalize_graph``, with the same
        BuildConfig the base was built with. The searches expand through
        the fused f32 layout over the grown rows, as the build's do: the
        base's layout extended row-wise (``serve.layout.extend_layout``),
        or packed anew if the base had none. Ids are stable: delta row j
        becomes id ``base_n + j``, the id the merged search returned.
        """
        if self.delta.n == 0:
            return False
        base = self.base
        bcfg = base.build_cfg
        if bcfg.row_width != int(base.graph.shape[1]):
            # a legacy archive (no build_cfg key) loads with the default
            # BuildConfig: folding rows at the wrong degree would corrupt
            # the graph, so refuse; inserts and searches still work
            raise ValueError(
                f"build_cfg.row_width {bcfg.row_width} != graph row width "
                f"{int(base.graph.shape[1])} (legacy archive loaded with "
                f"default BuildConfig?): cannot compact; rebuild the base "
                f"index or save a modern archive")
        from ..serve.engine import make_fetch_fn
        from ..serve.layout import build_layout, extend_layout
        xv, dattr = self.delta.device()
        dev = base.device
        xb_new = torch.cat([base.xb, xv])
        attr_new = base.attr.append(dattr)
        xb_norm = sq_norms(xb_new)
        lay = (extend_layout(base._fused["f32"], xv, dattr)
               if "f32" in base._fused else build_layout(xb_new, attr_new))
        fetch_fn = make_fetch_fn(lay)
        n0, m = int(base.xb.shape[0]), self.delta.n
        graph = torch.cat([base.graph,
                           torch.full((m, bcfg.row_width), -1,
                                      dtype=torch.int32, device=dev)])
        degree = torch.cat([base.degree.to(torch.int32),
                            torch.zeros((m,), dtype=torch.int32,
                                        device=dev)])
        insert = make_insert_step(bcfg)
        bsz = bcfg.batch_size
        new_ids = np.arange(n0, n0 + m, dtype=np.int64)
        n_batches = (m + bsz - 1) // bsz
        for pass_i in range(bcfg.n_passes):
            for i in range(n_batches):
                ids = new_ids[i * bsz:(i + 1) * bsz]
                if len(ids) < bsz:   # pad the last batch cyclically
                    ids = np.resize(ids, bsz)
                insert(graph, degree, xb_new, xb_norm, attr_new,
                       torch.as_tensor(ids, device=dev), base.entry,
                       fetch_fn)
                if verbose:
                    print(f"  compaction pass {pass_i + 1}/{bcfg.n_passes} "
                          f"batch {i + 1}/{n_batches}", flush=True)
            finalize_graph(graph, degree, xb_new, xb_norm, attr_new, bcfg)
        new_base = JAGIndex(xb_new, attr_new, graph, degree, base.entry,
                            base.cfg, bcfg)
        new_base._fused["f32"] = lay
        self.base = new_base
        self.delta.reset()
        self._merged = None
        self.epoch += 1
        self.n_compactions += 1
        if self.telemetry is not None and self.telemetry.enabled:
            self.telemetry.on_compaction()
        return True

    # -- queries (base route + delta scan, merged exactly) -----------------
    def _spans(self):
        """The attached telemetry's span recorder, if any."""
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return None
        return getattr(tel, "spans", None)

    def _with_delta(self, base_res: SearchResult, q, filt,
                    k: int) -> SearchResult:
        if self.telemetry is not None and self.telemetry.enabled:
            self.telemetry.on_search(delta_scanned=self.delta.n > 0)
        if self.delta.n == 0:
            return base_res
        self._last_k = int(k)
        be = self.compaction_break_even(k)
        if be is not None:          # the predicted tax actually paid
            self.delta_tax_us += be[0] * int(q.shape[0])
        spans = self._spans()
        with _span(spans, "delta", rows=self.delta.n):
            extra = self.executor.delta(q, filt, k=k)
        with _span(spans, "merge"):
            return self.executor.merge(base_res, extra, k=k)

    def search(self, queries, filt, k: int = 10, ls: int = 64,
               max_iters: int = 0, layout: str = "default") -> SearchResult:
        """JAG traversal over the graph segment and the exact delta scan,
        merged."""
        filt, q = as_filter(filt), self._q(queries)
        base = JAGIndex.search(self, q, filt, k=k, ls=ls,
                               max_iters=max_iters, layout=layout)
        return self._with_delta(base, q, filt, k)

    def search_int8(self, queries, filt, k: int = 10, ls: int = 64,
                    max_iters: int = 0,
                    layout: str = "default") -> SearchResult:
        """int8 traversal and exact re-rank on the graph segment, merged
        with the (always full-precision) delta scan."""
        filt, q = as_filter(filt), self._q(queries)
        base = JAGIndex.search_int8(self, q, filt, k=k, ls=ls,
                                    max_iters=max_iters, layout=layout)
        return self._with_delta(base, q, filt, k)

    def search_auto(self, queries, filt, k: int = 10, ls: int = 64,
                    max_iters: int = 0, planner=None,
                    return_plan: bool = False, mode: str = "per_query",
                    layout: str = "default", dtype: str = "f32",
                    on_group=None):
        """Selectivity-adaptive search over the live base + delta database:
        ``JAGIndex.search_auto`` over the graph segment (the planner probes
        the merged table), then the delta scan merged in, once for the
        whole batch whatever the route split. The realized route names end
        in ``+delta`` while the delta holds rows. An attached telemetry's
        shadow auditor samples the merged result, the one served."""
        filt, q = as_filter(filt), self._q(queries)
        base, p = JAGIndex.search_auto(
            self, q, filt, k=k, ls=ls, max_iters=max_iters, planner=planner,
            return_plan=True, mode=mode, layout=layout, dtype=dtype,
            on_group=on_group)
        res = self._with_delta(base, q, filt, k)
        if self.delta.n > 0:
            p = p._replace(realized=(
                p.realized + "+delta" if isinstance(p.realized, str)
                else tuple(r + "+delta" for r in p.realized)))
        tel = self.telemetry
        if (tel is not None and tel.enabled
                and getattr(tel, "shadow", None) is not None):
            tel.shadow_audit(self, q, filt, res, p, k=k)
        return (res, p) if return_plan else res

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """One archive: the base's ``JAGIndex`` arrays (a plain
        ``JAGIndex.load`` recovers the graph segment) and the live state
        under ``stream__*``: epoch, compaction count and fraction, query
        horizon, and the delta rows bit for bit (attr words as uint32, as
        the base's). The wrapper's cost model is the one saved (``cost__*``):
        a detached model stays detached."""
        arrs = self.base._save_arrays(self.cost_model, self.cost_metric)
        xv, attrs = self.delta.rows()
        arrs["stream__epoch"] = np.asarray(self.epoch, np.int64)
        arrs["stream__n_compactions"] = np.asarray(self.n_compactions,
                                                   np.int64)
        arrs["stream__compact_frac"] = np.asarray(self.compact_frac,
                                                  np.float64)
        arrs["stream__query_horizon"] = np.asarray(self.query_horizon,
                                                   np.int64)
        arrs["stream__delta_xv"] = xv
        for k, v in attrs.items():
            arrs[f"stream__delta_attr__{k}"] = (
                v.view(np.uint32) if k in ("bits", "assign") else v)
        np.savez_compressed(path, **arrs)

    @classmethod
    def load(cls, path: str, device=None) -> "StreamingJAGIndex":
        """Resume mid-stream on ``device`` (default "cuda"): epoch, delta
        rows, cost model and search results as saved. A frozen
        ``JAGIndex`` archive loads too, at epoch 0 with an empty delta."""
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            base = JAGIndex.from_arrays(z, device=dev)
            if "stream__epoch" not in z:
                return cls(base)
            idx = cls(base, epoch=int(z["stream__epoch"]),
                      compact_frac=float(z["stream__compact_frac"]),
                      n_compactions=int(z["stream__n_compactions"]),
                      query_horizon=int(z["stream__query_horizon"])
                      if "stream__query_horizon" in z else 100_000)
            xv = z["stream__delta_xv"]
            if xv.shape[0]:
                pre = "stream__delta_attr__"
                rows = AttrTable(base.attr.kind,
                                 {k[len(pre):]: _from_numpy(z[k], dev)
                                  for k in z.keys() if k.startswith(pre)},
                                 base.attr.n_bits)
                idx.delta.append(xv, rows)
        return idx
