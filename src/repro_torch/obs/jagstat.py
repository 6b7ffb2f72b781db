"""jagstat: per-route serving summary from a telemetry trace dump (the
JAX-free counterpart of ``tools/jagstat.py``).

Usage:
    python -m repro_torch.obs.jagstat TRACES.jsonl [--drift-threshold X]
                                      [--json]
    python -m repro_torch.obs.jagstat TRACES.jsonl --health
                                      [--shadow SHADOW.jsonl]
                                      [--slo-recall X] [--slo-p99-us Y]

Default mode prints one row per realized route: traffic share, latency
percentiles (p50/p95/p99 us over per-query wall time), mean n_dist (the
work/recall proxy), median predicted-vs-observed relative cost error,
and drift status. The input is a ``TraceBuffer.dump_jsonl`` file (the
reference's format; produce one with
``Telemetry().traces.dump_jsonl(path)``).

``--health`` instead renders the fused pass/warn/fail SLO document
(``repro_torch.obs.health``) over the trace window, optionally joined with
a shadow-audit dump (``ShadowAuditor.dump_jsonl``) for the recall
section. The exit code is 1 only when the overall status is ``fail``.

Empty or truncated dumps are not errors: jagstat prints an explicit
"no traces" line and exits 0, so log rotation racing a dump never turns
into a paging incident.
"""
import argparse
import json
import os
import sys

import numpy as np

from .drift import relative_error
from .trace import load_jsonl


def summarize(records, threshold=0.5):
    """Per-realized-route summary rows, route-name sorted."""
    groups = {}
    for t in records:
        groups.setdefault(t.route, []).append(t)
    total = sum(len(v) for v in groups.values()) or 1
    rows = []
    for route in sorted(groups):
        rs = groups[route]
        lat = np.asarray([t.observed_us for t in rs], np.float64)
        errs = [e for e in (relative_error(t) for t in rs) if e is not None]
        med = float(np.median(errs)) if errs else None
        rows.append({
            "route": route,
            "queries": len(rs),
            "share_pct": round(100.0 * len(rs) / total, 1),
            "p50_us": round(float(np.percentile(lat, 50)), 1),
            "p95_us": round(float(np.percentile(lat, 95)), 1),
            "p99_us": round(float(np.percentile(lat, 99)), 1),
            "mean_n_dist": round(float(np.mean([t.n_dist for t in rs])), 1),
            "rel_err": None if med is None else round(med, 3),
            "drift": None if med is None else bool(med > threshold),
        })
    return rows


def render(rows):
    cols = ("route", "queries", "share%", "p50us", "p95us", "p99us",
            "n_dist~", "relerr~", "drift")
    table = [cols]
    for r in rows:
        table.append((
            r["route"], str(r["queries"]), str(r["share_pct"]),
            str(r["p50_us"]), str(r["p95_us"]), str(r["p99_us"]),
            str(r["mean_n_dist"]),
            "-" if r["rel_err"] is None else str(r["rel_err"]),
            "-" if r["drift"] is None else ("DRIFT" if r["drift"] else "ok")))
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
                     for row in table)


def run_health(records, args) -> int:
    """``--health``: render the fused SLO document; exit 1 only on fail."""
    from .health import HealthSLO, health_report, render_health
    from .shadow import load_shadow_jsonl
    shadow = load_shadow_jsonl(args.shadow) if args.shadow else ()
    slo = HealthSLO(recall=args.slo_recall,
                    p99_us=args.slo_p99_us,
                    drift_threshold=args.drift_threshold)
    report = health_report(records, shadow, slo)
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
    else:
        print(render_health(report))
    return 1 if report["status"] == "fail" else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-route serving summary from a telemetry trace dump")
    ap.add_argument("traces", help="JSONL file from TraceBuffer.dump_jsonl")
    ap.add_argument("--drift-threshold", type=float, default=0.5,
                    help="median rel-err above this flags DRIFT (default .5)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary (or health report) as JSON")
    ap.add_argument("--health", action="store_true",
                    help="render the pass/warn/fail serving health report")
    ap.add_argument("--shadow", default=None, metavar="PATH",
                    help="shadow-audit JSONL (ShadowAuditor.dump_jsonl) "
                         "for the --health recall section")
    ap.add_argument("--slo-recall", type=float, default=0.9,
                    help="--health recall@k floor per cell (default .9)")
    ap.add_argument("--slo-p99-us", type=float, default=None,
                    help="--health per-route p99 latency bound in us "
                         "(default: latency not judged)")
    args = ap.parse_args(argv)

    records = load_jsonl(args.traces) if os.path.exists(args.traces) else []
    if args.health:
        return run_health(records, args)
    if not records:
        print(f"no traces: 0 records in {args.traces}")
        return 0
    rows = summarize(records, args.drift_threshold)
    if args.json:
        json.dump(rows, sys.stdout, indent=1)
        print()
    else:
        print(f"# {len(records)} traces, {len(rows)} routes "
              f"(drift threshold {args.drift_threshold})")
        print(render(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
