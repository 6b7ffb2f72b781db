"""Serving on PyTorch: layout, engine, planner, dispatch and executor
(counterparts of ``repro.serve``).

layout.py packs [vec | norm | attr] rows (f32 or int8 lanes) so one gather
per beam expansion feeds the comparator; engine.py builds the ``fetch_fn``
that plugs it into greedy_search; planner.py estimates filter selectivity
and routes whole batches or single queries; dispatch.py gathers per-query
route groups into sub-batches and scatters the results back; executor.py
owns the epoch-keyed route cache behind every ``JAGIndex.search*`` entry
point (prefilter | graph | postfilter, and delta | merge for a streaming
index); sharded.py serves an index split row-wise over a list of devices
behind the same surface (``ShardedJAGIndex``, ``shard_index``).
"""
from .dispatch import (dispatch_per_query, fold_topk, merge_topk, regroup,
                       run_route)
from .engine import FusedEngine, make_fetch_fn
from .executor import Executor
from .layout import (FusedLayout, build_layout, extend_layout, load_layout,
                     save_layout)
from .planner import (GroupPlan, Plan, PerQueryPlan, PlannerConfig, ROUTES,
                      choose_route, clause_eval_cost, estimate_selectivity,
                      explain, leaf_selectivities, leaf_validity, plan,
                      plan_per_query, reorder_clauses, sample_ids)

__all__ = ["Executor", "FusedEngine", "FusedLayout", "GroupPlan", "Plan",
           "PerQueryPlan", "PlannerConfig", "ROUTES", "build_layout",
           "choose_route", "clause_eval_cost", "dispatch_per_query",
           "estimate_selectivity", "explain", "extend_layout", "fold_topk",
           "leaf_selectivities", "leaf_validity", "load_layout",
           "make_fetch_fn", "merge_topk", "plan", "plan_per_query",
           "regroup", "reorder_clauses", "run_route", "sample_ids",
           "save_layout", "ShardedExecutor", "ShardedJAGIndex",
           "shard_index"]

_SHARDED = ("ShardedExecutor", "ShardedJAGIndex", "shard_index")


def __getattr__(name):
    # sharded.py imports core.jag, which imports this package (core.build
    # -> serve.engine) while it is still being defined: load it on first use
    if name in _SHARDED:
        from . import sharded
        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
