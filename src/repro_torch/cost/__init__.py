"""Calibrated cost model: measured per-route cost curves (counterpart of
``repro.cost``).

  calibrate.py  micro-benchmark harness: us/query and distance
                computations of every executor route (prefilter | graph |
                postfilter | delta | merge) plus the total compaction
                cost, over a selectivity x N x d x k x ls grid, timed
                through ``serve.Executor`` on the index's device.
  model.py      the fitted log-linear model per route, ``predict(route,
                features)``, and the ``CostModelRouter`` that routes each
                query to the argmin of predicted cost (the planner's static
                thresholds stay the fallback when no model covers the base
                routes). A copy of the reference's numpy module.
  registry.py   schema-versioned JSON persistence keyed by
                backend/dtype/layout; a model also rides inside
                ``JAGIndex`` archives (``cost__model``). The JSON form is the
                reference's, so a model's JSON loads in either package.

``JAGIndex.attach_cost_model`` / ``Executor.cost_router`` drive
``serve.planner.plan``/``plan_per_query``; ``StreamingJAGIndex`` compacts
at the predicted delta-tax vs compaction-cost break-even instead of
``compact_frac``.
"""
from .calibrate import (Calibration, calibrate, calibrate_shard_grid,
                        run_calibration, time_route)
from .model import (BASE_ROUTES, CostModel, CostModelRouter,
                    InterpolatedCostModel, Observation, feature_names, fit,
                    phi)
from .registry import (SCHEMA_VERSION, CostRegistry, from_json, model_key,
                       to_json)

__all__ = ["BASE_ROUTES", "Calibration", "CostModel", "CostModelRouter",
           "CostRegistry", "InterpolatedCostModel", "Observation",
           "SCHEMA_VERSION", "calibrate", "calibrate_shard_grid",
           "feature_names", "fit", "from_json", "model_key", "phi",
           "run_calibration", "time_route", "to_json"]
