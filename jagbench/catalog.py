"""Finds a cell's parts by name: ``BENCHMARK.json`` at the root, the
configuration's file (``configs/<name>.json``, as ``BENCHMARK.json``
names it), the traffic mix (``traffic/<name>.json``), the filter kind's
module (``kinds/<kind>.py``) and each metric's reader
(``metrics/<name>.py``). Nothing here names a cell, a configuration or a
metric: adding one is adding files and ``BENCHMARK.json`` entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _named(entries: List[dict], what: str) -> Dict[str, dict]:
    out = {}
    for e in entries:
        if not NAME.match(e["name"]):
            raise ValueError(f"{what} name {e['name']!r} is not a name")
        if e["name"] in out:
            raise ValueError(f"two {what}s named {e['name']!r}")
        out[e["name"]] = e
    return out


class Catalog:
    """``BENCHMARK.json`` of the checkout at ``root``, and the files of
    the benchmark beside it (``bench_dir``, default this package)."""

    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = _named(self.spec["configs"], "configuration")
        self.workloads = _named(self.spec["workloads"], "workload")
        self.metrics = _named(self.spec["end_to_end"] + self.spec["per_layer"],
                              "metric")
        for m in self.metrics.values():
            if not UNIT.match(m["unit"]):
                raise ValueError(f"unit {m['unit']!r} of {m['name']}")

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(self.workloads)}")
        return self.workloads[name]

    def config(self, name: str) -> dict:
        """The configuration's file as run (its path relative to the
        root, as ``BENCHMARK.json`` gives it)."""
        return json.loads((self.root / self.configs[name]["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json")
                          .read_text())

    def kind(self, name: str) -> ModuleType:
        if not re.match(r"^[a-z][a-z0-9_]*$", name):
            raise ValueError(f"filter kind {name!r}")
        return importlib.import_module(f"{__package__}.kinds.{name}")

    def metrics_of(self, workload: str, trace: bool) -> List[dict]:
        """The metrics a run of ``workload`` reports: its per-layer ones
        with ``trace``, else its end-to-end ones (a metric without a
        ``workloads`` list belongs to every cell)."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> ModuleType:
        """``metrics/<metric>.py``, loaded as a module: its ``read(run)``
        returns the metric's value, or None where it finds nothing."""
        path = self.dir / "metrics" / f"{metric}.py"
        mod_name = "jagbench_metric_" + re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no reader for metric {metric!r}: "
                                    f"{path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def limits(self, workload: str = "") -> Dict[str, float]:
        """The limits of every cell (``limits.json``), and those of
        ``workload`` alone (``limits/<workload>.json``, where there is
        one)."""
        out = json.loads((self.dir / "limits.json").read_text())
        own = self.dir / "limits" / f"{workload}.json"
        if workload and own.exists():
            out.update(json.loads(own.read_text()))
        return out
