"""The ``"pod"`` query axis of sharded serving on the port
(``repro_torch.core.distributed``: ``shard_axes``, ``query_axes``, the
``[P][S]`` grid of ``make_serve_step`` and ``make_build_step``) against the
reference's ``repro.core.distributed`` on the CPU.

- Against the reference: four 300-row shards (range attributes, d = 8),
  built by the port and handed over as an ``.npz``. The reference's
  ``make_serve_step`` runs in a subprocess on a (2, 2, 2) ("pod", "data",
  "model") mesh of 8 faked XLA CPU devices, the port's on a ``[[cpu] * 4]
  * 2`` grid; B = 16, k = 5, ls = 24, max_iters = 48, query_chunk 4, for
  ``f32`` and ``int8_reg``. ids and primary equal exactly, secondary within
  rtol = atol = 1e-5 (float32 sums in another order).
- Within the port: each pod row equals the flat step on its query slice
  bit for bit; the three mesh forms agree; a batch that does not split
  over the rows raises, and so does an accounting-only mesh;
  ``shard_axes`` and ``query_axes`` equal the reference's; the pod build
  equals the flat build; the registry's JAG cells hand a 2 x 256 grid to
  their steps on the multi-pod production mesh.
"""
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro_torch.configs import registry as TReg
from repro_torch.core import build as TB
from repro_torch.core import distributed as TD
from repro_torch.core import filters as TF
from repro_torch.core.jag import JAGConfig, JAGIndex
from repro_torch.core.quantized import quantize_int8
from repro_torch.launch.mesh import Mesh, make_production_mesh

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
S, N_LOC, D, B = 4, 300, 8, 16
CFG = TD.ShardedServeConfig(k=5, ls=24, max_iters=48, query_chunk=4)
GRID = [[CPU] * S] * 2
VARIANTS = ("f32", "int8_reg")

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, jax.numpy as jnp
from repro.core.distributed import make_serve_step, ShardedServeConfig
from repro.launch.mesh import mesh_kwargs, set_mesh
a = dict(np.load(sys.argv[2]))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), **mesh_kwargs(3))
cfg = ShardedServeConfig(k=5, ls=24, max_iters=48, query_chunk=4)
out = {}
for variant in ("f32", "int8_reg"):
    step = jax.jit(make_serve_step(mesh, cfg, "range", "range",
                                   variant=variant))
    args = [jnp.asarray(a["graphs"]),
            jnp.asarray(a["xb"] if variant == "f32" else a["codes"]),
            jnp.asarray(a["xbn"]), {"value": jnp.asarray(a["vals"])},
            jnp.asarray(a["entries"]), jnp.asarray(a["q"]),
            {"lo": jnp.asarray(a["lo"]), "hi": jnp.asarray(a["hi"])}]
    if variant != "f32":
        args.append(jnp.asarray(a["scale"]))
    with set_mesh(mesh):
        res = step(*args)
    for name, x in zip(("ids", "primary", "secondary"), res):
        out[f"{variant}_{name}"] = np.asarray(x)
np.savez(sys.argv[3], **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def shards():
    """Four 300-row shards (range attributes) built by the port, 16
    queries, and the int8 codes of the rows."""
    rng = np.random.default_rng(0)
    xb = rng.normal(size=(S, N_LOC, D)).astype(np.float32)
    vals = rng.uniform(0, 100, (S, N_LOC)).astype(np.float32)
    cfg = JAGConfig(degree=10, ls_build=16, batch_size=128, cand_pool=48)
    graphs, entries = [], []
    for s in range(S):
        idx = JAGIndex.build(xb[s], TF.range_table(vals[s], device="cpu"),
                             cfg, device="cpu")
        graphs.append(idx.graph.numpy())
        entries.append(np.resize(idx.entry.numpy(), 4))
    codes, scale = quantize_int8(torch.from_numpy(xb.reshape(-1, D)))
    lo = rng.uniform(0, 90, B).astype(np.float32)
    return dict(graphs=np.stack(graphs),
                entries=np.stack(entries).astype(np.int32), xb=xb,
                xbn=(xb.astype(np.float64) ** 2).sum(-1).astype(np.float32),
                vals=vals, codes=codes.numpy().reshape(S, N_LOC, D),
                scale=scale.numpy(),
                q=rng.normal(size=(B, D)).astype(np.float32), lo=lo,
                hi=lo + 10)


def _args(a, variant, rows=slice(None)):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    args = (t(a["graphs"]), t(a["xb"] if variant == "f32" else a["codes"]),
            t(a["xbn"]), {"value": t(a["vals"])}, t(a["entries"]),
            t(a["q"][rows]), {"lo": t(a["lo"][rows]), "hi": t(a["hi"][rows])})
    return args + (() if variant == "f32" else (t(a["scale"]),))


def _serve(mesh, a, variant, rows=slice(None), cfg=CFG):
    step = TD.make_serve_step(mesh, cfg, "range", "range", variant=variant)
    return tuple(x.numpy() for x in step(*_args(a, variant, rows)))


def test_pod_grid_equals_the_reference_pod_mesh(shards, tmp_path):
    np.savez(tmp_path / "shards.npz", **shards)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(ROOT / "src"),
         str(tmp_path / "shards.npz"), str(tmp_path / "ref.npz")],
        capture_output=True, text=True, env=env, timeout=600)
    assert "REFERENCE_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    want = np.load(tmp_path / "ref.npz")
    for variant in VARIANTS:
        ids, prim, sec = _serve(GRID, shards, variant)
        assert ids.shape == (B, CFG.k)
        np.testing.assert_array_equal(ids, want[f"{variant}_ids"])
        np.testing.assert_array_equal(prim, want[f"{variant}_primary"])
        np.testing.assert_allclose(sec, want[f"{variant}_secondary"],
                                   rtol=1e-5, atol=1e-5)
        assert (prim == 0).mean() > 0.9, variant


@pytest.mark.parametrize("variant", VARIANTS)
def test_each_pod_row_equals_the_flat_step_on_its_slice(shards, variant):
    got = _serve(GRID, shards, variant)
    half = B // 2
    for p, rows in enumerate((slice(0, half), slice(half, B))):
        want = _serve([CPU] * S, shards, variant, rows)
        for g, w in zip(got, want):
            assert g[rows].tobytes() == w.tobytes(), p
    # the same grid as a launch.mesh.Mesh, row-major over its axes
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2), (CPU,) * 8)
    for g, w in zip(_serve(mesh, shards, variant), got):
        assert g.tobytes() == w.tobytes()


def test_each_shard_searches_only_its_rows_slice(shards, monkeypatch):
    """At query_chunk 128 the flat step searches all 16 queries in one
    chunk; on the grid each of the 2 x 4 shards searches its row's 8."""
    seen = []
    real = TD.greedy_search

    def spy(graph, xb, xb_norm, attr, q, *a, **k):
        seen.append(int(q.shape[0]))
        return real(graph, xb, xb_norm, attr, q, *a, **k)
    monkeypatch.setattr(TD, "greedy_search", spy)
    cfg = TD.ShardedServeConfig(k=5, ls=24, max_iters=48)
    got = _serve(GRID, shards, "f32", cfg=cfg)
    assert seen == [B // 2] * (2 * S)
    seen.clear()
    want = _serve([CPU] * S, shards, "f32", cfg=cfg)
    assert seen == [B] * S
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


def test_grid_validation(shards):
    step = TD.make_serve_step(GRID, CFG, "range", "range")
    args = list(_args(shards, "f32"))
    args[5] = args[5][:15]
    args[6] = {k: v[:15] for k, v in args[6].items()}
    with pytest.raises(ValueError, match="2 pod rows"):
        step(*args)
    with pytest.raises(ValueError, match="accounting-only"):
        TD.make_serve_step(make_production_mesh(multi_pod=True), CFG,
                           "range", "range")
    with pytest.raises(ValueError, match="differ in length"):
        TD.as_grid([[CPU] * 2, [CPU] * 3])
    grid = TD.as_grid(Mesh(("pod", "data", "model"), (2, 2, 2),
                           tuple(torch.device("cpu", i) for i in range(8))))
    assert [[d.index for d in row] for row in grid] == [[0, 1, 2, 3],
                                                       [4, 5, 6, 7]]
    # a "data"-major mesh still takes its rows from "pod"
    grid = TD.as_grid(Mesh(("data", "pod"), (2, 2),
                           tuple(torch.device("cpu", i) for i in range(4))))
    assert [[d.index for d in row] for row in grid] == [[0, 2], [1, 3]]


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model"), ("data",)])
def test_axes_equal_the_reference(names):
    sizes = {"pod": 2, "data": 16, "model": 16}
    mesh = Mesh(names, tuple(sizes[n] for n in names))
    ref = SimpleNamespace(axis_names=names)
    assert TD.shard_axes(mesh) == RD.shard_axes(ref)
    assert TD.query_axes(mesh) == RD.query_axes(ref)


def test_pod_build_equals_the_flat_build():
    rng = np.random.default_rng(4)
    n_loc = 96
    bcfg = TB.BuildConfig(degree=8, ls_build=16, batch_size=32,
                          cand_pool=32, thresholds=(float("inf"), 0.0),
                          ex_slots=4, ov_max=64)
    xb = torch.from_numpy(rng.normal(size=(2, n_loc, D)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (2, n_loc)).astype(
        np.int32))
    graph = torch.full((2, n_loc, bcfg.row_width), -1, dtype=torch.int32)
    degree = torch.zeros((2, n_loc), dtype=torch.int32)
    graph[:, 0, 0], degree[:, 0] = 1, 1
    args = (torch.sum(xb * xb, -1), {"label": labels},
            torch.arange(32, dtype=torch.int32).repeat(2, 1),
            torch.zeros((2, 1), dtype=torch.int32))
    outs = [TD.make_build_step(mesh, bcfg, "label")(
        graph.clone(), degree.clone(), xb, *args)
        for mesh in ([CPU] * 2, [[CPU] * 2] * 3)]
    for (g1, d1), (g2, d2) in zip(zip(*outs[0]), zip(*outs[1])):
        assert torch.equal(g1, g2) and torch.equal(d1, d2)
        assert int((d1 > 0).sum()) > 1


@pytest.mark.parametrize("shape", ["serve_1b", "build_1b"])
def test_jag_cell_hands_its_step_a_pod_grid(shape, monkeypatch):
    seen = {}
    for name in ("make_serve_step", "make_build_step"):
        real = getattr(TD, name)

        def spy(mesh, *a, _real=real, **k):
            seen["mesh"] = mesh
            return _real(mesh, *a, **k)
        monkeypatch.setattr(TD, name, spy)
    cell = TReg.make_cell("jag", shape, make_production_mesh(multi_pod=True))
    grid = seen["mesh"]
    assert [len(row) for row in grid] == [256, 256]
    assert all(d == torch.device("meta") for row in grid for d in row)
    assert cell["analytic_only"]
    if shape == "serve_1b":
        # each row serves `batch` queries: Bq = batch x pod
        assert cell["args"][5].shape[0] == 2 * 4096
