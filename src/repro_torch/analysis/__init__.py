"""Static analysis for the port's serving stack: ``jagcheck``'s two layers
(counterpart of ``repro.analysis``).

* :mod:`repro_torch.analysis.lint`: an AST lint over ``src/repro_torch``
  with the reference's rules JAG001-JAG006 in PyTorch's terms (compile and
  capture surface, batch-invariant candidate dots, no module-level
  lru_cache over tensors, epoch-keyed executor caches, no host syncs and
  no telemetry inside route bodies), configured by
  ``analysis/jagcheck.toml``.
* :mod:`repro_torch.analysis.audit`: the route auditor. It builds the
  reference's audit index, replays every executor route (and the sharded
  routes over a device list of 8) under an op recorder, and holds the
  contracts: one gather per expansion on fused routes, no f64 op, S packed
  gathers and nothing else across devices per sharded call, host syncs
  within their budget.

Run both as ``python -m repro_torch.analysis``; the exit code is non-zero
on a finding, a config error or a violation.
"""
from .audit import check_report, run_audit  # noqa: F401
from .lint import Finding, LintConfig, lint_source, run_lint  # noqa: F401
