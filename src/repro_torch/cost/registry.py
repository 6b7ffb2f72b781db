"""Schema-versioned JSON persistence for calibration artifacts (a copy of
``repro.cost.registry``).

A fitted :class:`~repro_torch.cost.model.CostModel` is hardware truth — it is
only valid for the (backend, dtype, layout) combination it was measured
on, so artifacts are keyed by exactly that triple (``cpu-f32-default``,
``cuda-int8-fused``, ...). Two persistence paths share one JSON codec:

  * :class:`CostRegistry` — a directory of ``cost-<key>.json`` files, the
    fleet-level store benchmarks write and servers warm-start from;
  * ``JAGIndex.save``/``load`` — an attached model rides INSIDE the index
    archive (``cost__model`` uint8 key), so a restored index routes
    exactly like the one that was saved, no registry lookup needed.

``from_json`` refuses artifacts from a different schema version loudly —
a silently re-interpreted coefficient vector would mis-route every query.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

from .model import CostModel, InterpolatedCostModel

SCHEMA_VERSION = 1


def model_key(backend: str, dtype: str = "f32", layout: str = "default",
              shard_shape: Optional[Sequence[float]] = None) -> str:
    """The registry key one calibration is valid for.

    ``shard_shape = (n, d)`` suffixes the per-shard grid a sharded-serving
    calibration was measured at (``cpu-f32-default@n125000-d64``): one
    hardware triple holds many grid entries, and
    :func:`CostRegistry.load_shard_grids` folds them into an
    :class:`~repro_torch.cost.model.InterpolatedCostModel` so a fresh shard
    count predicts without a dedicated calibration pass.
    """
    base = f"{backend}-{dtype}-{layout}"
    if shard_shape is None:
        return base
    n, d = (int(shard_shape[0]), int(shard_shape[1]))
    return f"{base}@n{n}-d{d}"


def to_json(model: CostModel) -> str:
    """Serialize a model (coefficients + meta + fit stats), stamped with
    the schema version."""
    return json.dumps({"schema": SCHEMA_VERSION, "coef": model.coef,
                       "meta": model.meta, "fit_stats": model.fit_stats},
                      indent=1, sort_keys=True)


def from_json(text: str) -> CostModel:
    """Inverse of :func:`to_json`; raises on any other schema version."""
    payload = json.loads(text)
    schema = payload.get("schema")
    if schema != SCHEMA_VERSION:
        raise ValueError(f"cost-model artifact schema {schema!r} != "
                         f"supported {SCHEMA_VERSION} — recalibrate "
                         f"instead of re-interpreting coefficients")
    return CostModel(coef=payload["coef"], meta=payload.get("meta", {}),
                     fit_stats=payload.get("fit_stats", {}))


class CostRegistry:
    """A directory of calibration artifacts, one JSON file per key."""

    def __init__(self, root: str):
        self.root = root

    def path(self, key: str) -> str:
        return os.path.join(self.root, f"cost-{key}.json")

    def key_of(self, model: CostModel) -> str:
        m = model.meta
        return model_key(m.get("backend", "unknown"),
                         m.get("dtype", "f32"),
                         m.get("layout", "default"),
                         m.get("shard_shape"))

    def save(self, model: CostModel) -> str:
        """Write the model under its own metadata key; returns the path."""
        os.makedirs(self.root, exist_ok=True)
        path = self.path(self.key_of(model))
        with open(path, "w") as fh:
            fh.write(to_json(model))
        return path

    def load(self, backend: str, dtype: str = "f32",
             layout: str = "default") -> Optional[CostModel]:
        """The stored model for this hardware key, or None (uncalibrated
        is a normal state — callers fall back to static thresholds)."""
        path = self.path(model_key(backend, dtype, layout))
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            return from_json(fh.read())

    def load_shard_grids(self, backend: str, dtype: str = "f32",
                         layout: str = "default"
                         ) -> Optional[InterpolatedCostModel]:
        """Every per-shard grid calibrated for this hardware key, folded
        into one :class:`~repro_torch.cost.model.InterpolatedCostModel`.

        Collects all ``<base>@n<N>-d<D>`` entries; returns None when no
        grid has been calibrated (the normal uncalibrated state — sharded
        serving then falls back to static thresholds like everything
        else). A loaded grid missing its ``shard_shape`` meta is a
        corrupted artifact and raises rather than silently mis-keying.
        """
        prefix = model_key(backend, dtype, layout) + "@n"
        grids = []
        for key in self.keys():
            if not key.startswith(prefix):
                continue
            with open(self.path(key)) as fh:
                grids.append(from_json(fh.read()))
        if not grids:
            return None
        return InterpolatedCostModel(
            grids, meta=dict(backend=backend, dtype=dtype, layout=layout))

    def keys(self) -> Tuple[str, ...]:
        """Every calibrated key present in the registry directory."""
        if not os.path.isdir(self.root):
            return ()
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("cost-") and name.endswith(".json"):
                out.append(name[len("cost-"):-len(".json")])
        return tuple(out)
