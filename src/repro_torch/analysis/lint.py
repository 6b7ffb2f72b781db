"""Layer 1 of the port's static analysis: the AST lint (counterpart of
``repro.analysis.lint``).

The reference's six rules keep their codes, read in PyTorch's terms:

  JAG001  no ``torch.compile``, ``torch.jit.script``/``trace`` or CUDA-graph
          capture (``torch.cuda.graph``, ``CUDAGraph``,
          ``make_graphed_callables``) outside the ``jit_allowed`` surface:
          a compiled or captured route variant lives in the executor's
          epoch-keyed cache, where it stays enumerable and evictable.
  JAG002  no batch-variant ``einsum("bcd,bd->bc", ...)`` candidate dot (the
          spec normalized for whitespace): a batched product picks its
          blocking per batch size, so a query's low-order bits would follow
          its group. Use ``distances.gathered_dot``.
  JAG003  no module-level ``functools.lru_cache``/``cache``: a module-level
          memo holding tensors pins them for the life of the process.
          Cache on the owning object.
  JAG004  any ``*._cache[...]`` insertion key names the data epoch: an
          epoch-less key serves a closure built before the index grew.
  JAG005  no host sync inside a route body: ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``; ``bool``, ``float`` or ``int`` of a
          tensor; ``np.asarray``/``np.array``; ``torch.cuda.synchronize``.
          A shape read (``int(x.shape[0])``, ``len(...)``, ``.numel()``,
          ``.size(...)``, ``.dim()``) is no sync and is not flagged.
  JAG006  no ``time.*`` clock read and no telemetry mutation (``append``,
          ``observe``, ``inc``, ``record*`` on a telemetry, metric or trace
          object) inside a route body: telemetry is host work done after
          the route returns, in the dispatch wrappers.

Route bodies are the functions and lambdas defined inside a ``make()``
factory (the executor's and the sharded executor's route closures) and the
functions the config names in ``route_roots`` as ``path::function``
(nested functions included).

Diagnostics are ``path:line: CODE message``. The config and allowlist live
in ``analysis/jagcheck.toml`` (the reference's schema: ``include``,
``jit_allowed``, ``route_roots``, ``[[allow]]`` entries with ``rule``,
``path`` and ``reason``, and one key of the port's own, ``count``: how
many findings the entry suppresses), read with ``tomllib``. An entry
with no reason or no count, and an entry that matches another number of
findings than its count (none: a stale entry; more: a new finding
hidden behind an old reason), are JAGCFG findings.

The scan is syntactic and per file, as the reference's: a rule sees one
module's AST; what a route body calls in another module is that module's
own route root or nothing. The audit (``analysis/audit.py``) counts the
host syncs a route really makes at run time.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import tomllib
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

RULES = {
    "JAG001": "torch.compile / torch.jit / CUDA-graph capture outside the "
              "executor/build/launch surface",
    "JAG002": "batch-variant einsum candidate dot (use "
              "distances.gathered_dot)",
    "JAG003": "module-level lru_cache can pin tensors process-wide",
    "JAG004": "cache insertion key lacks an epoch component",
    "JAG005": "host sync inside a route body",
    "JAG006": "telemetry host work inside a route body",
    # meta-diagnostics about the config itself
    "JAGCFG": "jagcheck configuration problem",
}

_EINSUM_SPEC = "bcd,bd->bc"
CONFIG_NAME = "jagcheck.toml"
CONFIG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CONFIG_NAME)
# the repository root that ``include`` and every path are relative to
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
_CFG_REL = "src/repro_torch/analysis/" + CONFIG_NAME

_COMPILERS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.jit.trace_module", "torch.cuda.graph",
              "torch.cuda.CUDAGraph", "torch.cuda.make_graphed_callables")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix path relative to the repo root
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    rule: str
    path: str          # fnmatch glob over the relative posix path
    reason: str
    count: int         # the findings it suppresses, exactly


@dataclasses.dataclass
class LintConfig:
    include: Tuple[str, ...] = ("src/repro_torch",)
    # JAG001's allowed surface (fnmatch globs): the rule, not suppressions
    jit_allowed: Tuple[str, ...] = (
        "src/repro_torch/serve/executor.py",
        "src/repro_torch/core/build.py",
        "src/repro_torch/launch/*.py",
    )
    # "path-glob::function" route bodies besides the make() factories
    route_roots: Tuple[str, ...] = ()
    allow: Tuple[AllowEntry, ...] = ()


# ---------------------------------------------------------------------------
# config loading (analysis/jagcheck.toml)
# ---------------------------------------------------------------------------

def load_config(path: str = CONFIG_PATH) -> Tuple[LintConfig, List[Finding]]:
    """Read the lint config at ``path``.

    Returns (config, config-errors): an allowlist entry missing its
    ``reason`` (or ``rule``/``path``/``count``) is a JAGCFG finding, not a
    crash, so the lint exits non-zero on it as on an unjustified finding.
    """
    errors: List[Finding] = []
    if not os.path.exists(path):
        return LintConfig(), errors
    with open(path, "rb") as fh:
        cfg = tomllib.load(fh)
    allow: List[AllowEntry] = []
    for i, ent in enumerate(cfg.get("allow", [])):
        rule = str(ent.get("rule", "")).strip()
        glob = str(ent.get("path", "")).strip()
        reason = str(ent.get("reason", "")).strip()
        count = ent.get("count")
        if not (rule in RULES and glob):
            errors.append(Finding(
                "JAGCFG", _CFG_REL, 1,
                f"allow entry #{i + 1} needs a known rule and a path "
                f"(got rule={rule!r}, path={glob!r})"))
            continue
        if not reason:
            errors.append(Finding(
                "JAGCFG", _CFG_REL, 1,
                f"allow entry #{i + 1} ({rule} {glob}) has no reason: "
                f"every suppression needs a one-line justification"))
            continue
        if not (isinstance(count, int) and count > 0):
            errors.append(Finding(
                "JAGCFG", _CFG_REL, 1,
                f"allow entry #{i + 1} ({rule} {glob}) needs a count: the "
                f"number of findings it suppresses (got {count!r})"))
            continue
        allow.append(AllowEntry(rule, glob, reason, count))
    out = LintConfig(
        include=tuple(cfg.get("include", LintConfig.include)),
        jit_allowed=tuple(cfg.get("jit_allowed", LintConfig.jit_allowed)),
        route_roots=tuple(cfg.get("route_roots", LintConfig.route_roots)),
        allow=tuple(allow))
    return out, errors


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """'torch.compile' for Attribute(Name('torch'), 'compile'); '' if not
    a plain dotted path."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _mentions_epoch(node: ast.AST) -> bool:
    """Does any name/attribute inside the expression contain 'epoch'?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and "epoch" in sub.attr.lower():
            return True
        if isinstance(sub, ast.Name) and "epoch" in sub.id.lower():
            return True
    return False


def _decorator_is_lru(dec: ast.AST) -> bool:
    names = ("lru_cache", "functools.lru_cache", "cache", "functools.cache")
    if _dotted(dec) in names:
        return True
    return isinstance(dec, ast.Call) and _dotted(dec.func) in names


def _is_shape_read(node: ast.AST) -> bool:
    """``x.shape[0]``, ``len(x)``, ``x.numel()``, ``x.size(0)``,
    ``x.dim()``, ``x.ndim``: host-side metadata, no device read."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "numel", "size", "dim", "element_size"):
            return True
        if isinstance(sub, ast.Call) and _dotted(sub.func) == "len":
            return True
    return False


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _jag001(tree: ast.AST, path: str, cfg: LintConfig) -> List[Finding]:
    if any(fnmatch.fnmatch(path, g) for g in cfg.jit_allowed):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and _dotted(node) in _COMPILERS:
            out.append(Finding(
                "JAG001", path, node.lineno,
                f"{_dotted(node)} outside serve/executor.py, core/build.py "
                "and launch/: a compiled or captured route must live in "
                "the executor's epoch-keyed cache"))
    return out


def _jag002(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _dotted(node.func).split(".")[-1] == "einsum"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        spec = node.args[0].value.replace(" ", "")
        if spec == _EINSUM_SPEC:
            out.append(Finding(
                "JAG002", path, node.lineno,
                f'batch-variant einsum("{_EINSUM_SPEC}") candidate dot: '
                "use distances.gathered_dot (a batched product's blocking "
                "follows the batch size, breaking per-query bit-identity)"))
    return out


def _jag003(tree: ast.Module, path: str) -> List[Finding]:
    out = []
    for node in tree.body:  # module level only: that is the bug class
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _decorator_is_lru(dec):
                    out.append(Finding(
                        "JAG003", path, dec.lineno,
                        f"module-level lru_cache on {node.name}() can pin "
                        "tensors process-wide: cache on the owning "
                        "object"))
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Call):
            call = node.value
            if _decorator_is_lru(call.func) or _decorator_is_lru(call):
                out.append(Finding(
                    "JAG003", path, node.lineno,
                    "module-level lru_cache assignment can pin tensors "
                    "process-wide: cache on the owning object"))
    return out


def _jag004(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if not (isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Attribute)
                    and tgt.value.attr == "_cache"):
                continue
            if not _mentions_epoch(tgt.slice):
                out.append(Finding(
                    "JAG004", path, node.lineno,
                    "_cache insertion key has no epoch component: an "
                    "epoch-less key serves a stale route after a streaming "
                    "insert or compaction"))
    return out


class _RouteRoots(ast.NodeVisitor):
    """Function nodes whose bodies are route bodies: every function or
    lambda defined inside a ``make()`` factory, and the functions named
    in ``names`` (qualified names, ``Class.method`` for methods)."""

    def __init__(self, names: Sequence[str] = ()):
        self.roots: List[ast.AST] = []
        self._names = set(names)
        self._scope: List[str] = []

    def visit_FunctionDef(self, node):
        qual = ".".join(self._scope + [node.name])
        if qual in self._names:
            self.roots.append(node)
        if node.name == "make":
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.Lambda)) \
                        and sub is not node:
                    self.roots.append(sub)
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()


def _route_roots(tree: ast.AST, path: str, cfg: LintConfig) -> List[ast.AST]:
    names = [r.split("::", 1)[1] for r in cfg.route_roots
             if "::" in r and fnmatch.fnmatch(path, r.split("::", 1)[0])]
    vis = _RouteRoots(names)
    vis.visit(tree)
    return vis.roots


_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_FUNCS = ("np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "torch.cuda.synchronize")


def _jag005(roots: List[ast.AST], path: str) -> List[Finding]:
    out = []
    seen = set()
    for root in roots:
        for node in ast.walk(root):
            if not isinstance(node, ast.Call) or node.lineno in seen:
                continue
            what = None
            fn = _dotted(node.func)
            if fn in _SYNC_FUNCS:
                what = fn + "()"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args:
                what = f".{node.func.attr}()"
            elif fn in ("bool", "float", "int") and node.args \
                    and not isinstance(node.args[0], ast.Constant) \
                    and not _is_shape_read(node.args[0]):
                what = f"{fn}() of a tensor"
            if what:
                seen.add(node.lineno)
                out.append(Finding(
                    "JAG005", path, node.lineno,
                    f"{what} inside a route body makes the host wait for "
                    "the device"))
    return out


_JAG006_TIMERS = ("time.time", "time.perf_counter", "time.monotonic",
                  "time.time_ns", "time.perf_counter_ns",
                  "time.monotonic_ns", "perf_counter", "monotonic")
_JAG006_MUTATORS = ("append", "observe", "inc", "record", "record_call")


def _jag006_chain(node: ast.AST) -> str:
    """Dotted chain like ``_dotted`` but seeing through calls:
    ``tel.metrics.counter("x").inc`` -> ``tel.metrics.counter.inc``."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        else:
            break
    return ".".join(reversed(parts))


def _jag006_owner_is_telemetry(chain: str) -> bool:
    """True when a dotted owner chain names a telemetry object: ``tel``,
    or a segment holding ``telemetry``/``metric``/``trace``. The
    executor's ``trace_log`` analysis hook is exempt."""
    for seg in chain.lower().split(".")[:-1]:
        if seg == "trace_log":
            continue
        if seg == "tel" or "telemetry" in seg or "metric" in seg \
                or "trace" in seg:
            return True
    return False


def _jag006(roots: List[ast.AST], path: str) -> List[Finding]:
    out = []
    seen = set()
    for root in roots:
        for node in ast.walk(root):
            if not isinstance(node, ast.Call) or node.lineno in seen:
                continue
            fn = _dotted(node.func)
            what = None
            if fn in _JAG006_TIMERS:
                what = (f"{fn}() reads the host clock inside a route body; "
                        "time in the host-side wrapper around the route")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _JAG006_MUTATORS \
                    and _jag006_owner_is_telemetry(
                        fn or _jag006_chain(node.func)):
                what = (f"telemetry mutation "
                        f"{fn or _jag006_chain(node.func)}() inside a route "
                        "body; record after the route returns")
            if what:
                seen.add(node.lineno)
                out.append(Finding("JAG006", path, node.lineno, what))
    return out


# ---------------------------------------------------------------------------
# running the lint
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str,
                cfg: Optional[LintConfig] = None) -> List[Finding]:
    """Lint one module's source text (``path`` is the repo-relative posix
    path the rules, route roots and allowlist match against)."""
    cfg = cfg or LintConfig()
    tree = ast.parse(src)
    roots = _route_roots(tree, path, cfg)
    out = []
    out += _jag001(tree, path, cfg)
    out += _jag002(tree, path)
    out += _jag003(tree, path)
    out += _jag004(tree, path)
    out += _jag005(roots, path)
    out += _jag006(roots, path)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]          # unsuppressed: these fail the lint
    suppressed: List[Tuple[Finding, AllowEntry]]
    config_errors: List[Finding]     # bad or stale allowlist entries

    @property
    def ok(self) -> bool:
        return not self.findings and not self.config_errors

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per rule: unjustified and allowlisted findings."""
        out = {r: {"findings": 0, "allowlisted": 0} for r in RULES}
        for f in self.findings + self.config_errors:
            out[f.rule]["findings"] += 1
        for f, _ in self.suppressed:
            out[f.rule]["allowlisted"] += 1
        return out


def run_lint(root: str = REPO_ROOT, cfg: Optional[LintConfig] = None,
             config_errors: Optional[Sequence[Finding]] = None
             ) -> LintReport:
    """Lint every ``*.py`` under the config's include dirs (relative to
    ``root``; the config defaults to ``analysis/jagcheck.toml``).

    Findings matched by a justified allowlist entry are suppressed and
    reported apart; an allowlist entry that matched another number of
    findings than its ``count`` is a JAGCFG finding: one that matched
    nothing is stale and would swallow the next real regression at that
    path, one that matched more hides a new finding behind an old reason.
    """
    if cfg is None:
        cfg, errs = load_config()
        config_errors = list(errs) + list(config_errors or [])
    findings: List[Finding] = []
    for inc in cfg.include:
        base = os.path.join(root, inc)
        for dirpath, dirs, files in os.walk(base):
            dirs.sort()
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                with open(full) as fh:
                    src = fh.read()
                try:
                    findings += lint_source(src, rel, cfg)
                except SyntaxError as e:
                    findings.append(Finding(
                        "JAGCFG", rel, e.lineno or 1,
                        f"unparseable module: {e.msg}"))
    kept: List[Finding] = []
    suppressed: List[Tuple[Finding, AllowEntry]] = []
    used = Counter()
    for f in findings:
        ent = next((a for a in cfg.allow
                    if a.rule == f.rule and fnmatch.fnmatch(f.path, a.path)),
                   None)
        if ent is not None:
            suppressed.append((f, ent))
            used[ent] += 1
        else:
            kept.append(f)
    errs = list(config_errors or [])
    for a in cfg.allow:
        if not used[a]:
            errs.append(Finding(
                "JAGCFG", _CFG_REL, 1,
                f"stale allowlist entry: {a.rule} {a.path} matched no "
                f"finding; remove it so it cannot mask a future one"))
        elif used[a] != a.count:
            errs.append(Finding(
                "JAGCFG", _CFG_REL, 1,
                f"allowlist entry {a.rule} {a.path} states {a.count} "
                f"finding(s) and matched {used[a]}: fix the new one or "
                f"restate the entry"))
    return LintReport(kept, suppressed, errs)


def format_report(report: LintReport) -> List[str]:
    """The lint's output lines: findings, each allowlisted finding with
    its reason, then the per-rule counts."""
    lines = [str(f) for f in report.findings + report.config_errors]
    lines += [f"# allowed {f.rule} {f.path}:{f.line}: {ent.reason}"
              for f, ent in report.suppressed]
    per_rule = ", ".join(f"{r} {c['findings']}+{c['allowlisted']}"
                         for r, c in report.counts().items())
    n = len(report.findings) + len(report.config_errors)
    lines.append(f"# jagcheck lint: {n} finding(s), "
                 f"{len(report.suppressed)} allowlisted (per rule, "
                 f"findings+allowlisted: {per_rule})")
    return lines
