"""The port's static analysis and launch tooling (``repro_torch.analysis``,
``repro_torch.launch``, ``repro_torch.obs.jagstat``) against the
reference's ``repro.analysis``, ``repro.launch`` and ``tools/jagstat.py``.

Held here, on the CPU:
- every lint rule on a positive fixture (its bug class) and a negative one
  (the sanctioned idiom), as ``tests/test_analysis.py`` holds the
  reference's, in PyTorch's terms; the framework-free rules JAG003 and
  JAG004 give the same findings as ``repro.analysis.lint.lint_source`` on
  the same source text; reason-less and stale allowlist entries; the
  repo's lint is burned down;
- the audit (one run per module) covers the 13 single-device and 4
  sharded routes with zero violations; each route's gathers per expansion
  equals the reference's ``audit_single_device()`` on the same data (the
  port counts what ran, so ``gathers_total`` and the operand counts are
  per run, not per program, and are not compared); the introspective
  twins equal their routes; ``check_report`` flags injected violations;
- ``Executor.trace_log`` is None by default, and arming it leaves ids and
  keys bit-identical;
- ``launch.roofline`` returns PERF.md's kernel bounds to the printed
  digits; ``launch.trace_stats`` parses a synthetic op record and a
  synthetic profiler trace;
- ``python -m repro_torch.obs.jagstat`` prints what ``tools/jagstat.py``
  prints, with its exit codes, on an empty dump, a port dump and under
  ``--health``.
"""
import copy
import importlib.util
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import audit as raudit
from repro.analysis import lint as rlint
from repro_torch.analysis import audit as AU
from repro_torch.analysis.lint import (AllowEntry, LintConfig, lint_source,
                                       load_config, run_lint)
from repro_torch.core import filters as TF
from repro_torch.core.jag import JAGIndex
from repro_torch.launch import roofline as RL
from repro_torch.launch import trace_stats as TS
from repro_torch.obs import Telemetry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def codes(src, path="src/repro_torch/serve/planner.py", cfg=None):
    return [f.rule for f in lint_source(textwrap.dedent(src), path, cfg)]


# ---------------------------------------------------------------------------
# the lint: one positive + one negative fixture per rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    "torch.compile(lambda x: x + 1)",
    "torch.jit.script(f)",
    "torch.jit.trace(f, (x,))",
    "torch.cuda.graph(g)",
    "torch.cuda.CUDAGraph()",
    "torch.cuda.make_graphed_callables(f, (x,))",
])
def test_jag001_compile_outside_surface(call):
    src = f"import torch\nstep = {call}\n"
    assert codes(src, "src/repro_torch/core/jag.py") == ["JAG001"]
    # the three sanctioned surfaces pass untouched
    for ok in ("src/repro_torch/serve/executor.py",
               "src/repro_torch/core/build.py",
               "src/repro_torch/launch/roofline.py"):
        assert codes(src, ok) == []


def test_jag001_decorator_form():
    src = """
    import torch

    @torch.compile(mode="reduce-overhead")
    def f(k, x):
        return x * k

    @torch.jit.script
    def g(x):
        return x + 1
    """
    assert codes(src, "src/repro_torch/stream/index.py") == ["JAG001",
                                                             "JAG001"]


def test_jag002_einsum_candidate_dot():
    # the bug class: a batched candidate dot whose blocking follows B
    src = """
    import torch

    def dist_fn(rows, q32, q_norm):
        d2 = (torch.sum(rows * rows, -1)
              - 2.0 * torch.einsum("bcd,bd->bc", rows, q32)
              + q_norm[:, None])
        return torch.clamp_min(d2, 0.0)
    """
    assert codes(src) == ["JAG002"]
    # the sanctioned replacement, and a non-candidate-dot einsum spec
    ok = """
    import torch
    from repro_torch.core.distances import gathered_dot

    def dist_fn(rows, q32):
        return gathered_dot(rows, q32) + torch.einsum(
            "bd,bd->b", rows[:, 0], rows[:, 0])[:, None]
    """
    assert codes(ok) == []


def test_jag002_spec_whitespace_normalized():
    assert codes('import torch\n'
                 'y = torch.einsum("bcd, bd -> bc", a, b)\n') == ["JAG002"]


JAG003_SOURCES = [
    """
    import functools
    import torch

    @functools.lru_cache(maxsize=None)
    def sample_ids(n, n_samples, seed=0):
        return torch.arange(n)[:n_samples]
    """,
    "import functools\nmemo = functools.lru_cache(None)(lambda n: n)\n",
    """
    from functools import cache

    @cache
    def table(n):
        return n
    """,
    # owned by an object: the sanctioned shape
    """
    import functools

    class Executor:
        @functools.lru_cache(maxsize=None)
        def _probe(self, n):
            return n
    """,
]


def test_jag003_module_level_lru_cache():
    assert codes(JAG003_SOURCES[0]) == ["JAG003"]
    assert codes(JAG003_SOURCES[1]) == ["JAG003"]
    assert codes(JAG003_SOURCES[2]) == ["JAG003"]
    assert codes(JAG003_SOURCES[3]) == []


JAG004_SOURCES = [
    # the stale-route bug class: the key omits the data epoch
    """
    class Executor:
        def run(self, key, make, *args):
            fn = self._cache.get(key)
            if fn is None:
                fn = self._cache[key] = make()
            return fn(*args)
    """,
    """
    class Executor:
        def run(self, key, make, *args):
            fn = self._cache[(self._cache_epoch,) + key] = make()
            return fn(*args)
    """,
    """
    def put(ex, key, fn, epoch):
        ex._cache[(epoch, key)] = fn
        ex._cache[key] = fn
    """,
]


def test_jag004_epoch_less_cache_key():
    path = "src/repro_torch/serve/executor.py"
    assert codes(JAG004_SOURCES[0], path) == ["JAG004"]
    assert codes(JAG004_SOURCES[1], path) == []
    assert codes(JAG004_SOURCES[2], path) == ["JAG004"]


@pytest.mark.parametrize("src", JAG003_SOURCES + JAG004_SOURCES)
def test_framework_free_rules_match_the_reference_lint(src):
    """JAG003 and JAG004 read no framework call, so on the same source
    text the port's lint and the reference's find the same lines."""
    src = textwrap.dedent(src)
    path = "src/repro_torch/serve/executor.py"
    mine = [(f.rule, f.line) for f in lint_source(src, path)
            if f.rule in ("JAG003", "JAG004")]
    theirs = [(f.rule, f.line) for f in rlint.lint_source(src, path)
              if f.rule in ("JAG003", "JAG004")]
    assert mine == theirs


@pytest.mark.parametrize("body,what", [
    ("return x.item()", ".item()"),
    ("return x.tolist()", ".tolist()"),
    ("return x.cpu()", ".cpu()"),
    ("return x.numpy()", ".numpy()"),
    ("return bool(x.all())", "bool()"),
    ("return float(x.sum())", "float()"),
    ("return int(x.max())", "int()"),
    ("return np.asarray(x)", "np.asarray()"),
    ("torch.cuda.synchronize()\n            return x",
     "torch.cuda.synchronize()"),
])
def test_jag005_host_sync_in_make_closures(body, what):
    src = f"""
    import numpy as np
    import torch

    def make():
        def run(x):
            {body}
        return run
    """
    found = lint_source(textwrap.dedent(src),
                        "src/repro_torch/serve/planner.py")
    assert [f.rule for f in found] == ["JAG005"]
    assert what in found[0].msg


def test_jag005_route_roots_and_shape_reads():
    src = """
    import torch

    def greedy_search(x, beam_vis):
        n = int(x.shape[0])             # a shape read: no sync
        m = len(x) + int(x.numel()) + int(x.size(0))
        for it in range(n):
            if bool(beam_vis.all()):
                break
        return m

    def helper(x):
        return x.item()                 # not a route body
    """
    cfg = LintConfig(route_roots=("src/repro_torch/core/*.py::greedy_search",))
    assert codes(src, "src/repro_torch/core/beam_search.py", cfg) == \
        ["JAG005"]
    # without the root the same text is host code
    assert codes(src, "src/repro_torch/core/beam_search.py") == []
    # a method named as Class.method
    meth = """
    class Engine:
        def fetch(self, x):
            return float(x)
    """
    cfg = LintConfig(route_roots=("src/repro_torch/serve/engine.py::"
                                  "Engine.fetch",))
    assert codes(meth, "src/repro_torch/serve/engine.py", cfg) == ["JAG005"]
    # the same calls outside any route body are host-side and fine
    ok = """
    import numpy as np

    def probe(x):
        return float(np.asarray(x).mean()) + x.cpu().numpy().sum()
    """
    assert codes(ok) == []


def test_jag006_telemetry_in_route_bodies():
    factory = """
    def make():
        def run(x):
            self.telemetry.traces.append(x)
            return x
        return run
    """
    assert codes(factory) == ["JAG006"]
    metric = """
    def make():
        def run(x):
            tel.metrics.counter("jag_x").inc()
            return x
        return run
    """
    assert codes(metric) == ["JAG006"]
    timer = """
    import time

    def make():
        def run(x):
            t0 = time.perf_counter()
            return x, t0
        return run
    """
    assert codes(timer) == ["JAG006"]


def test_jag006_host_side_telemetry_is_fine():
    # the dispatch wrappers' shape: timing and recording around the route
    ok = """
    import time
    import torch

    def timed(route, *args):
        t0 = time.perf_counter()
        out = route(*args)
        torch.cuda.synchronize()
        tel.metrics.counter("jag_route_call_total").inc()
        tel.traces.append(out)
        return out, time.perf_counter() - t0
    """
    assert codes(ok) == []
    plain = """
    def make():
        def run(xs):
            out = []
            out.append(xs)
            return out
        return run
    """
    assert codes(plain) == []
    # the executor's trace_log analysis hook is exempt by name
    log = """
    def make():
        def run(x):
            self.trace_log.append(x)
            return x
        return run
    """
    assert codes(log) == []


def test_lint_real_executor_passes():
    path = "src/repro_torch/serve/executor.py"
    with open(os.path.join(REPO, path)) as fh:
        assert codes(fh.read(), path) == []


# ---------------------------------------------------------------------------
# config / allowlist
# ---------------------------------------------------------------------------

def test_config_file_schema():
    cfg, errors = load_config()
    assert errors == []
    assert cfg.include == ("src/repro_torch",)
    assert "src/repro_torch/serve/executor.py" in cfg.jit_allowed
    assert {r.split("::")[1] for r in cfg.route_roots} >= {
        "greedy_search", "exact_filtered_knn", "make_fetch_fn"}
    assert all(a.reason for a in cfg.allow)


def test_allow_entry_requires_reason(tmp_path):
    path = tmp_path / "jagcheck.toml"
    path.write_text(textwrap.dedent("""
        include = ["src/repro_torch"]

        [[allow]]
        rule = "JAG001"
        path = "src/repro_torch/x.py"

        [[allow]]
        rule = "JAG999"
        path = "src/repro_torch/y.py"
        reason = "not a rule"

        [[allow]]
        rule = "JAG003"
        path = "src/repro_torch/z.py"
        reason = "no count"
    """))
    cfg, errors = load_config(str(path))
    assert not cfg.allow
    assert [e.rule for e in errors] == ["JAGCFG"] * 3
    assert "reason" in errors[0].msg and "known rule" in errors[1].msg
    assert "needs a count" in errors[2].msg


def test_stale_allowlist_entry_is_flagged(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "clean.py").write_text("x = 1\n")
    cfg = LintConfig(allow=(AllowEntry("JAG002", "src/repro_torch/gone.py",
                                       "used to matter", 1),))
    report = run_lint(str(tmp_path), cfg, [])
    assert not report.findings
    assert [e.rule for e in report.config_errors] == ["JAGCFG"]
    assert "stale" in report.config_errors[0].msg


def test_allowlist_entry_holds_its_count(tmp_path):
    """An entry suppresses the number of findings it states: a second
    finding at its path is a JAGCFG error, not a silent suppression."""
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "m.py").write_text(textwrap.dedent("""
        import functools

        @functools.lru_cache(maxsize=None)
        def a():
            return 1
    """))
    entry = AllowEntry("JAG003", "src/repro_torch/m.py", "a memo", 1)
    report = run_lint(str(tmp_path), LintConfig(allow=(entry,)), [])
    assert report.ok and len(report.suppressed) == 1
    (pkg / "m.py").write_text((pkg / "m.py").read_text() + textwrap.dedent("""

        @functools.lru_cache(maxsize=None)
        def b():
            return 2
    """))
    report = run_lint(str(tmp_path), LintConfig(allow=(entry,)), [])
    assert not report.ok and len(report.suppressed) == 2
    assert [e.rule for e in report.config_errors] == ["JAGCFG"]
    assert "states 1 finding(s) and matched 2" in \
        report.config_errors[0].msg


def test_repo_lint_is_burned_down():
    """Zero unjustified findings over src/repro_torch; the one suppressed
    finding is the traversal's early-stop read."""
    report = run_lint()
    assert report.ok, [str(f) for f in
                       report.findings + report.config_errors]
    assert [(f.rule, f.path) for f, _ in report.suppressed] == [
        ("JAG005", "src/repro_torch/core/beam_search.py")]
    counts = report.counts()
    assert counts["JAG005"] == {"findings": 0, "allowlisted": 1}


def test_lint_cli_exit_code():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--lint-only"], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s), 1 allowlisted" in r.stdout


def test_audit_cli_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="cuda"):
        AU.run_audit()


def test_audit_cli_no_sharded(monkeypatch, tmp_path, capsys):
    """``--no-sharded`` audits the single-device routes only; the report
    has no sharded section and the exit code follows the violations."""
    from repro_torch.analysis.__main__ import main
    routes = {"prefilter": dict(
        f64_ops=0, collectives={}, host_syncs=0, host_sync_budget=0,
        iterations=[], gathers_per_expansion=None, gathers_total=1)}
    monkeypatch.setattr(AU, "audit_single_device",
                        lambda dev: {"meta": {"device": "cpu"},
                                     "routes": routes})

    def no_sharded(*a, **k):
        raise AssertionError("--no-sharded ran the sharded section")
    monkeypatch.setattr(AU, "audit_sharded_routes", no_sharded)
    out = tmp_path / "audit.json"
    assert main(["--audit-only", "--no-sharded", "--device", "cpu",
                 "--json", str(out)]) == 0
    assert "sharded" not in json.loads(out.read_text())
    routes["prefilter"]["host_syncs"] = 1
    assert main(["--audit-only", "--no-sharded", "--device", "cpu"]) == 1
    assert "prefilter: 1 host syncs" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the audit (one run each, module-scoped)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_audit():
    return AU.run_audit("cpu")


@pytest.fixture(scope="module")
def ref_audit():
    return raudit.audit_single_device()


GRAPH = {f"graph:{la}:{dt}" for la in ("default", "fused")
         for dt in ("f32", "int8")}


def test_audit_covers_every_route(port_audit):
    assert set(port_audit["routes"]) == (
        {"prefilter", "postfilter", "unfiltered", "delta", "merge"}
        | GRAPH | {g + ":introspect" for g in GRAPH})
    assert set(port_audit["sharded"]["routes"]) == set(AU.SHARDED_ROUTES)
    assert port_audit["sharded"]["meta"]["mesh"] == ["cpu"] * 8
    assert port_audit["meta"]["telemetry"] is True
    assert port_audit["violations"] == []


def test_audit_gathers_per_expansion_equal_the_reference(port_audit,
                                                         ref_audit):
    assert ref_audit["meta"]["n"] == port_audit["meta"]["n"]
    assert ref_audit["meta"]["graph_width"] == \
        port_audit["meta"]["graph_width"]
    assert ref_audit["meta"]["packed_row_width"] == \
        port_audit["meta"]["packed_row_width"]
    for name, r in ref_audit["routes"].items():
        assert port_audit["routes"][name]["gathers_per_expansion"] == \
            r["gathers_per_expansion"], name
    for name, r in port_audit["routes"].items():
        if name.startswith("graph:fused"):
            assert r["gathers_per_expansion"] == 1, (name, r)
        elif name.startswith("graph:default") or name in ("postfilter",
                                                          "unfiltered"):
            assert r["gathers_per_expansion"] == 3, (name, r)
        else:
            assert r["gathers_per_expansion"] is None, (name, r)


def test_audit_introspective_twins_equal_their_routes(port_audit):
    routes = port_audit["routes"]
    twins = [n for n in routes if n.endswith(":introspect")]
    assert len(twins) == 4
    for name in twins:
        twin = routes[name.rsplit(":introspect", 1)[0]]
        r = routes[name]
        for key in ("gathers_per_expansion", "host_syncs", "iterations",
                    "collectives", "f64_ops", "adjacency_gathers"):
            assert r[key] == twin[key], (name, key)


def test_audit_host_syncs_are_the_loop_checks(port_audit):
    mi = port_audit["meta"]["max_iters"]
    for name, r in port_audit["routes"].items():
        assert r["f64_ops"] == 0 and r["collectives"] == {}, name
        if name.split(":")[0] in AU.TRAVERSALS:
            (it,) = r["iterations"]
            assert 0 < it <= mi and r["adjacency_gathers"] == it
            assert r["host_syncs"] == AU.loop_checks(it, mi) == \
                r["host_sync_budget"]
        else:
            assert r["host_syncs"] == r["host_sync_budget"] == 0, name


def test_audit_sharded_routes(port_audit):
    sh = port_audit["sharded"]
    S, payload = sh["meta"]["devices"], sh["meta"]["merge_payload_bytes"]
    assert payload == AU.AUDIT_B * (3 * AU.AUDIT_K + 2) * 4
    for name, r in sh["routes"].items():
        assert r["collectives"] == {"broadcast": S, "packed_gather": S}, name
        assert r["collective_bytes"]["packed_gather"] == S * payload
        assert r["f64_ops"] == 0
        assert len(r["iterations"]) == S
        assert r["host_syncs"] == r["host_sync_budget"], name
        if name == "prefilter":
            assert r["gathers_per_expansion"] is None
        else:
            assert r["gathers_per_expansion"] == 3
            assert r["host_syncs"] == sum(
                AU.loop_checks(it, AU.AUDIT_MI) for it in r["iterations"])


def test_audit_check_report_flags_violations(port_audit):
    assert AU.check_report(port_audit) == []
    bad = copy.deepcopy(port_audit)
    bad["routes"]["graph:fused:f32"]["gathers_per_expansion"] = 2
    bad["routes"]["graph:default:int8"]["gathers_per_expansion"] = 1
    bad["routes"]["prefilter"]["host_syncs"] = 1
    bad["routes"]["merge"]["f64_ops"] = 2
    bad["routes"]["delta"]["collectives"] = {"cross_device_copy": 1}
    bad["sharded"]["routes"]["graph"]["collectives"] = {"packed_gather": 9}
    bad["sharded"]["routes"]["unfiltered"]["host_syncs"] += 1
    msgs = AU.check_report(bad)
    assert len(msgs) == 7
    for needle in ("graph:fused:f32", "graph:default:int8",
                   "prefilter: 1 host syncs", "merge: 2 f64",
                   "delta: single-device", "sharded/graph",
                   "sharded/unfiltered"):
        assert any(needle in m for m in msgs), needle


def test_audit_stamp_is_compact(port_audit):
    stamp = AU.audit_stamp("cpu")
    assert set(stamp) == set(port_audit["routes"])
    assert stamp["graph:fused:f32"]["gathers_per_expansion"] == 1
    assert stamp["prefilter"]["host_syncs"] == 0


def test_loop_checks():
    from repro_torch.core.beam_search import CHECK_EVERY
    assert CHECK_EVERY == 8
    assert AU.loop_checks(0, 32) == 1          # all done at the first read
    assert AU.loop_checks(24, 32) == 4         # reads at 0, 8, 16, 24
    assert AU.loop_checks(32, 32) == 4         # no read after the last
    assert AU.loop_checks(12, 12) == 2
    assert AU.host_sync_budget("prefilter", [0], 32) == 0
    assert AU.host_sync_budget("graph", [8, 16], 32) == 5


# ---------------------------------------------------------------------------
# the executor's capture hook
# ---------------------------------------------------------------------------

def test_trace_log_is_off_by_default_and_changes_nothing():
    xb, tab, filt, q = AU._dataset(device=CPU)
    idx = JAGIndex.build(xb, tab, AU._build_cfg(), device=CPU)
    ex = idx.executor
    assert ex.trace_log is None

    def calls():
        return [ex.graph(q, filt, k=5, ls=16, max_iters=32, layout=lay)
                for lay in ("default", "fused")] + [
            ex.prefilter(q, filt, k=5), ex.postfilter(
                q, filt, k=5, ls=16, max_iters=32)]

    plain = calls()
    keys = ex.cache_keys()
    ex.trace_log = []
    armed = calls()
    assert [e[0] for e in ex.trace_log] == [
        ("graph", "default", "f32", 5, 16, 32, "range"),
        ("graph", "fused", "f32", 5, 16, 32, "range"),
        ("prefilter", "default", "f32", 5, 0, 0, "range", 4096, False),
        ("postfilter", "default", "f32", 5, 16, 32, "range")]
    ex.trace_log = None
    assert ex.cache_keys() == keys
    for a, b in zip(plain, armed):
        assert torch.equal(a.ids, b.ids)
        assert torch.equal(a.primary, b.primary)
        assert torch.equal(a.secondary, b.secondary)


# ---------------------------------------------------------------------------
# launch.roofline and launch.trace_stats
# ---------------------------------------------------------------------------

POPC = RL.popc_ops_per_s(132, 1980)


@pytest.mark.parametrize("name,shape,want,by", [
    ("fused_expand", dict(B=315, C=144, d=100, A=1), "0.0057249", "bytes"),
    ("gather_dist_tile", dict(B=568, tile=4096, dp=104), "0.0072227",
     "operations"),
    ("bitset_dist", dict(B=568, N=4096, W=1, popc_rate=POPC), "0.0027835",
     "bytes"),
    ("bitset_dist", dict(B=128, N=4096, W=1024, popc_rate=POPC), "0.1284",
     "operations"),
    ("gather_dist", dict(B=315, C=144, d=100), "0.0055621", "bytes"),
    ("l2dist", dict(B=1024, N=262144, d=100), "0.3519430", "bytes"),
    ("flash_attention", dict(B=4, H=16, Hkv=8, T=4096, D=128), "0.2779352",
     "operations"),
    ("flash_attention_f32", dict(B=4, H=16, Hkv=8, T=4096, D=128),
     "1.6659267", "operations"),
])
def test_roofline_returns_the_kernel_tables_bounds(name, shape, want, by):
    """PERF.md's kernel table prints these bounds (H100: 3.35 TB/s, 67
    TFLOP/s FP32, 989 bf16, 3 passes at 495 TF32, 132 SMs x 16 popcounts
    at 1,980 MHz); moving the formulas changed none of them."""
    ms, got_by = RL.kernel_bound_ms(name, **shape)
    places = len(want.split(".")[1])
    assert f"{ms:.{places}f}" == want
    assert got_by == by
    n_bytes, n_ops, rate = RL.kernel_work(name, **shape)
    rl = RL.analyze(name, n_bytes=n_bytes, n_ops=n_ops, rate=rate,
                    measured_s=2 * ms / 1e3)
    assert math.isclose(rl.bound_s * 1e3, ms, rel_tol=1e-12)
    assert math.isclose(rl.bound_share, 0.5, rel_tol=1e-12)
    assert rl.bottleneck == {"bytes": "memory", "operations": "compute"}[by]


def test_roofline_split_and_lm_flops():
    b, by, b32 = RL.kernel_split_bound_ms("l2dist", B=1024, N=262144, d=100)
    assert f"{b32:.7f}" == "0.8012999"     # the FP32 rate's figure
    rl = RL.analyze("decode", n_bytes=3.35e9, n_ops=1e11,
                    rate=RL.HW["bf16_flops"])
    assert rl.bottleneck == "memory" and rl.bound_share is None
    assert math.isclose(rl.bound_s, 1e-3) and rl.t_comp < rl.t_mem
    from repro_torch import configs
    cfg = configs.get("qwen3-1.7b").make_config()
    T = 4096
    mm = cfg.param_count() - cfg.padded_vocab * cfg.d_model \
        - cfg.n_layers * 2 * cfg.d_model - cfg.d_model
    pre = RL.lm_model_flops(cfg, 4, T, "prefill")
    attn = 2.0 * 4 * cfg.n_layers * cfg.n_heads * T * T * cfg.hd
    assert math.isclose(pre, 2.0 * 4 * T * mm + attn
                        + 2.0 * 4 * cfg.padded_vocab * cfg.d_model)
    dec = RL.lm_model_flops(cfg, 4, T, "decode")
    assert math.isclose(dec, 2.0 * 4 * (mm + cfg.padded_vocab * cfg.d_model)
                        + 4.0 * 4 * cfg.n_layers * cfg.n_heads * (T + 1)
                        * cfg.hd)
    with pytest.raises(ValueError):
        RL.lm_model_flops(cfg, 1, 1, "serve")


def _spec(shape, dtype="f32", device="cpu"):
    return TS.TensorSpec(tuple(shape), dtype, device)


def test_trace_stats_parse_a_synthetic_op_record():
    A = TS.OpRecord
    recs = [
        A("aten::index", (_spec((1000, 102)), _spec((4, 16), "i64")),
          (_spec((4, 16, 102)),)),
        A("kernel::fused_expand", (_spec((1000, 102), "f32", "cuda:0"),)),
        A("aten::_local_scalar_dense", (_spec((), "i1"),)),
        A("aten::index", (_spec((8, 3)), _spec((8,), "i1"))),   # mask
        A("aten::_to_copy", (_spec((4, 5), "f32", "cuda:0"),),
          (_spec((4, 5), "f32", "cpu"),)),                      # DtoH
        A("aten::_to_copy", (_spec((4, 5), "f32", "cpu"),),
          (_spec((4, 5), "f32", "cuda:0"),)),                   # upload
        A("aten::copy_", (_spec((4, 17), "i32", "cuda:1"),
                          _spec((4, 17), "i32", "cuda:0"))),    # collective
        A("aten::add", (_spec((4,), "f64"),), (_spec((4,), "f64"),)),
        A("cuda::synchronize"),
        A("collective::packed_gather", (_spec((4, 17), "i32", "cuda:1"),),
          (_spec((4, 17), "i32", "cuda:0"),)),
        A("collective::broadcast", (_spec((4, 8), "f32", "cuda:0"),
                                    _spec((4, 1), "i32", "cuda:0")),
          (_spec((4, 8), "f32", "cuda:1"), _spec((4, 1), "i32", "cuda:1"))),
    ]
    assert TS.host_syncs(recs) == 4
    assert TS.f64_ops(recs) == 1
    assert TS.collective_counts(recs) == {"cross_device_copy": 1,
                                          "packed_gather": 1, "broadcast": 1}
    assert TS.collective_bytes(recs) == {"cross_device_copy": 272,
                                         "packed_gather": 272,
                                         "broadcast": 144, "total": 688}
    assert TS.kernel_launches(recs) == {"fused_expand": 1}
    assert TS.op_histogram(recs)["aten::index"] == 2
    st = AU.analyze_record(recs, n_rows=1000, adj="1000x6xi32")
    assert st["data_gather_operands"] == {"1000x102xf32": 2}
    assert st["gathers_per_expansion"] is None       # no adjacency gather


def test_op_recorder_records_each_transfer_whole():
    """The sharded routes' two transfers are one record each, the copy
    inside left out, and the recorder restores them on exit."""
    from repro_torch.serve import sharded as SH
    send, to_shard = SH._send, SH._to_shard
    packed = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    q = torch.zeros((2, 4))
    filt = TF.subset_filters(np.ones((2, 3), bool), 3, device="cpu")
    with TS.OpRecorder() as rec:
        SH._send(packed, "meta")
        SH._to_shard(q, filt, "meta")
    assert [r.name for r in rec.records] == ["collective::packed_gather",
                                             "collective::broadcast"]
    assert rec.records[0].outputs[0] == _spec((2, 3), "i32", "meta")
    assert rec.records[1].outputs[0] == _spec((2, 4), "f32", "meta")
    assert len(rec.records[1].outputs) == 1 + len(filt.data)
    assert (SH._send, SH._to_shard) == (send, to_shard)


def test_op_recorder_records_real_ops():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    graph = torch.zeros((4, 2), dtype=torch.int32)

    def run():
        out = []
        for i in range(3):                 # three "iterations"
            nb = graph[torch.tensor([i])]            # adjacency gather
            out.append(x[nb.long().clamp(0, 3)])     # one data gather
            out.append(x[:, 0][nb.long()])           # not an N-row table
        bool((x > 0).any())
        x.to(torch.float64)
        torch.cuda.synchronize()
        return out

    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: None    # no card here
    try:
        _, recs = TS.record(run)
    finally:
        torch.cuda.synchronize = sync
    st = AU.analyze_record(recs, n_rows=4, adj="4x2xi32")
    assert st["adjacency_gathers"] == 3
    assert st["gathers_per_expansion"] == 2          # x and x[:, 0]: 4 rows
    assert st["host_syncs"] == 2                     # bool() and the sync
    assert st["f64_ops"] == 1
    assert torch.cuda.synchronize is not None


def test_profile_stats_parse_a_synthetic_trace():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::index", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "fused_expand_kernel", "ts": 10,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "sort", "ts": 12, "dur": 8},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": 40, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "fused_expand_kernel", "ts": 60,
         "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 41, "dur": 3},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1},
    ]
    st = TS.profile_stats(ev, wall_us=200)
    # busy: [10, 20] + [40, 42] + [60, 70] = 22 us of 200
    assert st["device_busy_us"] == 22 and st["device_busy_share"] == 0.11
    assert st["idle_gaps_us"] == [30, 20, 18, 10]   # tail, 20-40, 42-60, head
    assert st["idle_us"] == 78
    # the sync returned at 44, inside the idle stretch 42-60
    assert st["idle_at_syncs_us"] == 18
    assert st["kernel_launches"] == 3
    assert st["kernels"]["fused_expand_kernel"] == {"calls": 2,
                                                    "device_ms": 0.015}
    assert st["runtime_syncs"] == 1 and st["dtoh_copies"] == 1
    empty = TS.profile_stats([], wall_us=5)
    assert empty["device_busy_share"] == 0 and empty["kernel_launches"] == 0


def test_profile_needs_a_card():
    with pytest.raises((RuntimeError, AssertionError)):
        TS.profile(lambda: None)


# ---------------------------------------------------------------------------
# jagstat without JAX
# ---------------------------------------------------------------------------

def _reference_jagstat():
    path = os.path.join(REPO, "tools", "jagstat.py")
    spec = importlib.util.spec_from_file_location("ref_jagstat", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_dump(tmp_path_factory):
    d = tmp_path_factory.mktemp("jagstat")
    xb, tab, filt, q = AU._dataset(device=CPU)
    idx = JAGIndex.build(xb, tab, AU._build_cfg(), device=CPU)
    tel = idx.attach_telemetry(Telemetry(shadow=1.0, introspect=True))
    wide = TF.range_filters(np.zeros(4, np.float32),
                            np.ones(4, np.float32), device=CPU)
    for f in (filt, wide):
        idx.search_auto(q, f, k=5, ls=16)
    idx.attach_telemetry(None)
    traces, shadow = str(d / "traces.jsonl"), str(d / "shadow.jsonl")
    assert tel.traces.dump_jsonl(traces) == 8
    assert tel.shadow.dump_jsonl(shadow) == 8
    empty = str(d / "empty.jsonl")
    open(empty, "w").close()
    return {"traces": traces, "shadow": shadow, "empty": empty,
            "missing": str(d / "missing.jsonl")}


@pytest.mark.parametrize("args", [
    ["empty"], ["missing"], ["traces"], ["traces", "--json"],
    ["traces", "--drift-threshold", "0.01"],
    ["traces", "--health", "--shadow", "shadow"],
    ["traces", "--health", "--shadow", "shadow", "--json"],
    ["traces", "--health", "--slo-p99-us", "0.001"],
    ["traces", "--health", "--shadow", "shadow", "--slo-recall", "1.5"],
    ["empty", "--health"],
])
def test_jagstat_equals_the_reference_tool(port_dump, args, capsys):
    from repro_torch.obs import jagstat
    argv = [port_dump.get(a, a) for a in args]
    rc = jagstat.main(argv)
    mine = capsys.readouterr().out
    ref_rc = _reference_jagstat().main(argv)
    theirs = capsys.readouterr().out
    assert (rc, mine) == (ref_rc, theirs)
    if args[0] in ("empty", "missing") and "--health" not in args:
        assert mine.startswith("no traces: 0 records")
    if "--slo-p99-us" in args or "1.5" in args:
        assert rc == 1                      # a failed SLO exits 1
    elif "--health" not in args:
        assert rc == 0


def test_jagstat_module_entry_point(port_dump):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.jagstat",
                        port_dump["traces"]], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("# 8 traces")


def test_new_modules_import_no_jax():
    """The H100 machine has no JAX: the tooling imports none of it."""
    code = ("import sys\n"
            "import repro_torch.analysis.__main__, repro_torch.analysis.audit\n"
            "import repro_torch.launch.roofline, repro_torch.launch.trace_stats\n"
            "import repro_torch.obs.jagstat\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro'))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
