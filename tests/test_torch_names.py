"""The public names the port had lacked, against the reference on the CPU,
and a guard against new gaps.

- ``core/filters.py``: ``matches_all`` and ``selectivity`` on all four
  kinds and compound trees over a joint table, ``matches_counted``'s
  short-circuit eval counts, all exactly (comparisons and counts; the
  selectivity is one float32 mean of the same booleans); ``filter_batch``
  warns with the reference's text.
- The top-level exports: the port's ``__all__`` holds the reference's.
- ``launch/roofline.py``: ``save_all`` writes the reference's file layout
  (a JSON list of ``to_dict()``s, indent 1), ``load_all`` reads it back and
  reads the reference's rows.
- ``models/layers.py``: ``swiglu`` in float32 within 1e-6 of the largest
  output, for both activations; another ``act`` raises in both.
- The guard: every public top-level name of every module of
  ``src/repro/`` (by AST) is an attribute of its counterpart in
  ``repro_torch``, or stands in ``RENAMED`` or ``BY_DESIGN`` with its
  reason.
"""
import ast
import dataclasses
import importlib
import json
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import filters as RF
from repro.launch import roofline as RRL
from repro.models import layers as RL_
from repro_torch.core import filters as TF
from repro_torch.launch import roofline as TRL
from repro_torch.models import layers as TL

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, B, L = 300, 12, 10

# reference module -> port module, where the port's file has another name
MODULES = {
    "launch.hlo_stats": "launch.trace_stats",   # HLO text -> recorded ops
    # each Pallas kernel's wrapper: kernels/ops.py (sources in csrc/)
    "kernels.bitset": "kernels.ops", "kernels.flash_attn": "kernels.ops",
    "kernels.fused_expand": "kernels.ops", "kernels.gather_dist":
    "kernels.ops", "kernels.l2dist": "kernels.ops",
}
# (reference module, name) -> the port's name for it
RENAMED = {
    ("analysis.audit", "analyze_entry"): "analyze_record",
    ("analysis.audit", "run_sharded_audit"): "audit_sharded_routes",
    # the plain versions carry their kernel's name in kernels/ref.py
    ("kernels.ref", "l2dist_ref"): "l2dist",
    ("kernels.ref", "gather_dist_ref"): "gather_dist",
    ("kernels.ref", "fused_expand_ref"): "fused_expand",
    ("kernels.ref", "hamming_ref"): "hamming",
    ("kernels.ref", "subset_deficit_ref"): "subset_deficit",
    ("kernels.ref", "flash_attention_ref"): "flash_attention",
}
# (reference module, name) -> why the port has no counterpart
BY_DESIGN = {
    ("kernels.ops", "repro_force_interpret"):
        "switches Pallas interpret mode; a CUDA kernel has none",
    ("kernels.flash_attn", "NEG_INF"):
        "a constant of the Pallas kernel's body; csrc/ holds its own",
    ("launch.mesh", "mesh_kwargs"):
        "bridges jax.make_mesh's axis_types across JAX versions",
    ("launch.mesh", "set_mesh"):
        "bridges JAX's ambient-mesh context across JAX versions",
    ("analysis.audit", "main"):
        "the command line is python -m repro_torch.analysis",
    ("analysis.lint", "main"):
        "the command line is python -m repro_torch.analysis",
    ("models.layers", "Params"):
        "a type alias of a JAX parameter pytree; the port's are nn.Modules",
    ("models.layers", "Specs"):
        "a type alias of the pytree of logical axes; the port returns "
        "dicts from param_specs",
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cols = dict(labels=rng.integers(0, 6, N),
                values=rng.uniform(0, 100, N).astype(np.float32),
                bits=rng.integers(0, 2, (N, L)).astype(bool),
                assign=rng.integers(0, 2 ** L, N).astype(np.uint32))
    sat = rng.integers(0, 2, (B, 2 ** L)).astype(bool)
    sat[:, 0] = True
    lanes = dict(qlab=rng.integers(0, 6, B),
                 lo=rng.uniform(0, 70, B).astype(np.float32),
                 fbits=(rng.integers(0, 2, (B, L))
                        * (rng.integers(0, 3, (B, L)) == 0)).astype(bool),
                 sat=sat)
    return cols, lanes


def _both(mod, cols, lanes, **kw):
    tables = {TF.LABEL: mod.label_table(cols["labels"], **kw),
              TF.RANGE: mod.range_table(cols["values"], **kw),
              TF.SUBSET: mod.subset_table(cols["bits"], L, **kw),
              TF.BOOLEAN: mod.boolean_table(cols["assign"], L, **kw)}
    filts = {TF.LABEL: mod.label_filters(lanes["qlab"], **kw),
             TF.RANGE: mod.range_filters(lanes["lo"], lanes["lo"] + 30.0,
                                         **kw),
             TF.SUBSET: mod.subset_filters(lanes["fbits"], L, **kw),
             TF.BOOLEAN: mod.boolean_filters(lanes["sat"], L, **kw)}
    lab, rng_, sub, boo = (mod.Leaf(filts[k]) for k in TF.KINDS)
    trees = [lab & ~rng_, (sub | boo) & lab, ~(rng_ | sub) | (boo & ~lab)]
    return tables, filts, mod.joint_table(*tables.values()), trees


@pytest.fixture(scope="module")
def pair():
    cols, lanes = _data()
    return _both(RF, cols, lanes), _both(TF, cols, lanes, device="cpu")


def _cases(pair, which):
    (rt, rf, rj, rtrees), (tt, tf, tj, ttrees) = pair
    if which in TF.KINDS:
        return [(rf[which], rt[which], tf[which], tt[which])]
    return [(r, rj, t, tj) for r, t in zip(rtrees, ttrees)]


@pytest.mark.parametrize("which", TF.KINDS + ("compound",))
def test_matches_all_and_selectivity_equal_the_reference(pair, which):
    for rfilt, rtab, tfilt, ttab in _cases(pair, which):
        want = np.asarray(RF.matches_all(rfilt, rtab))
        got = TF.matches_all(tfilt, ttab)
        assert got.dtype == torch.bool and got.shape == (B, N)
        assert np.array_equal(got.numpy(), want)
        sel = TF.selectivity(tfilt, ttab)
        assert sel.dtype == torch.float32
        assert sel.numpy().tobytes() == np.asarray(
            RF.selectivity(rfilt, rtab)).tobytes()
        assert 0.0 < float(sel.mean()) < 1.0


def test_matches_counted_counts_equal_the_reference(pair):
    ids = np.random.default_rng(2).integers(0, N, (B, 40))
    for rfilt, rtab, tfilt, ttab in _cases(pair, "compound"):
        rok, rev = RF.matches_counted(rfilt, rtab.gather(jnp.asarray(
            ids, jnp.int32)))
        tok, tev = TF.matches_counted(tfilt, ttab.gather(
            torch.as_tensor(ids)))
        assert tev.dtype == torch.int32
        assert np.array_equal(tok.numpy(), np.asarray(rok))
        assert np.array_equal(tev.numpy(), np.asarray(rev))
        assert int(tev.min()) >= 1 and int(tev.max()) > 1


def test_filter_batch_warns_as_the_reference():
    lo = np.zeros(3, np.float32)
    data = {"lo": lo, "hi": lo + 1}
    with pytest.warns(DeprecationWarning) as rec:
        RF.filter_batch("range", {k: jnp.asarray(v) for k, v in
                                  data.items()})
    with pytest.warns(DeprecationWarning) as got:
        fb = repro_torch.filter_batch("range", data)
    assert str(got[0].message) == str(rec[0].message)
    assert got[0].filename == __file__          # stacklevel=2: the caller
    assert fb.kind == "range" and fb.batch == 3
    assert isinstance(fb.data["lo"], torch.Tensor)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TF.range_filters(lo, lo + 1, device="cpu")


def test_top_level_exports_hold_the_references():
    assert set(repro.__all__) <= set(repro_torch.__all__)
    for name in repro_torch.__all__:
        assert hasattr(repro_torch, name), name


def test_roofline_files_load_across_the_packages(tmp_path):
    rows = [TRL.analyze("fused_expand", n_bytes=1e6, n_ops=2e6, rate=67e12,
                        measured_s=2e-5),
            TRL.analyze("prefill", n_bytes=3e9, n_ops=4e13, rate=989e12)]
    path = tmp_path / "port.json"
    TRL.save_all(rows, str(path))
    text = path.read_text()
    assert text == json.dumps([r.to_dict() for r in rows], indent=1)
    assert TRL.load_all(str(path)) == rows
    # the reference's rows: one card's terms of a dry-run cell
    ref = RRL.Roofline("qwen3-1.7b", "train_4k", "16x16", 1.5e12, 3e9, 2e8,
                       {"all-reduce": 200000000}, 0.0076, 0.0037, 0.0040,
                       "compute", 3.1e14, 0.79, 2.4e10, 256)
    rpath = tmp_path / "ref.json"
    RRL.save_all([ref], str(rpath))
    assert RRL.load_all(str(rpath)) == [ref]
    got, = TRL.load_all(str(rpath))
    assert got == TRL.Roofline("qwen3-1.7b x train_4k x 16x16", 1.5e12, 3e9,
                               0.0076, 0.0037, "compute")


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_equals_the_reference(act):
    rng = np.random.default_rng(5)
    x, wg, wu = (rng.normal(size=s).astype(np.float32)
                 for s in ((2, 7, 16), (16, 48), (16, 48)))
    wd = rng.normal(size=(48, 16)).astype(np.float32)
    want = np.asarray(RL_.swiglu(*map(jnp.asarray, (x, wg, wu, wd)), act))
    got = TL.swiglu(*map(torch.from_numpy, (x, wg, wu, wd)), act).numpy()
    assert got.shape == want.shape == (2, 7, 16)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_swiglu_refuses_another_activation():
    x, w = torch.ones(2, 4), torch.ones(4, 4)
    with pytest.raises(ValueError):
        RL_.swiglu(jnp.ones((2, 4)), jnp.ones((4, 4)), jnp.ones((4, 4)),
                   jnp.ones((4, 4)), "relu")
    with pytest.raises(ValueError):
        TL.swiglu(x, w, w, w, "relu")


def _public_names(path: pathlib.Path):
    """Top-level defs, classes and assigned names; in an ``__init__``, the
    names it imports too (its exports). Private names are left out."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def test_every_public_reference_name_has_a_counterpart():
    src = ROOT / "src" / "repro"
    missing, used = [], set()
    for path in sorted(src.rglob("*.py")):
        rel = path.relative_to(src).with_suffix("")
        mod = ".".join(rel.parts[:-1] if rel.name == "__init__"
                       else rel.parts)
        port = importlib.import_module(
            ".".join(filter(None, ("repro_torch", MODULES.get(mod, mod)))))
        for name in sorted(_public_names(path)):
            if (mod, name) in BY_DESIGN:
                used.add((mod, name))
                continue
            if (mod, name) in RENAMED:
                used.add((mod, name))
                name = RENAMED[mod, name]
            if not hasattr(port, name):
                missing.append(f"{mod or 'repro'}.{name}")
    assert not missing, missing
    # every entry of the two lists still names a reference name
    assert used == set(BY_DESIGN) | set(RENAMED)
