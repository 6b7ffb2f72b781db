"""The port's cell registry and logical-axis sharding
(``repro_torch.configs.registry``, ``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) against the reference's on the CPU.

- ``all_archs()`` has the reference's 11 ids, and every shape table equals
  the reference's (``JAG_SHAPES`` included).
- Every (arch, shape) cell: ``n_params``, ``model_flops`` and
  ``flops_scale`` equal the reference's ``make_cell`` on a 1-device CPU
  mesh (which only ``eval_shape``s: nothing is compiled); the port builds
  its cell on the meta device.
- Every parameter of every published config: ``resolve_spec`` equals the
  reference's on the (16, 16) and (2, 16, 16) production meshes, with the
  default rules and with overrides. The reference's ``Rules`` reads only
  ``axis_names`` and ``shape`` of its mesh, so the port's ``Mesh`` record
  stands in for 512 fake devices. The reference stacks layers [L, ...]
  under the logical axis "layers", bound to no mesh axis; the port keeps
  one tensor a layer, so its spec is the reference's without that dim.
- ``opt_specs`` mirrors the parameters' specs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as RReg
from repro.configs import shapes as RShapes
from repro.distributed import sharding as RSh
from repro.launch.mesh import mesh_kwargs
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro.train import optimizer as ROpt
from repro_torch import configs
from repro_torch.configs import shapes as TShapes
from repro_torch.distributed import sharding as TSh
from repro_torch.launch import mesh as TMesh
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TOpt

torch.set_num_threads(1)

ARCH_IDS = sorted(RReg.all_archs())
MESHES = {"single": TMesh.make_production_mesh(),
          "multi": TMesh.make_production_mesh(multi_pod=True)}
OVERRIDES = {"lm": {"embed": None, "mlp": ("data", "model"),
                    "experts": "data"},
             "recsys": {"table_rows": "model", "mlp_in": None},
             "gnn": {"feat": "model"}, "jag": {}}


def test_registry_ids_and_shapes_copy_the_reference():
    assert sorted(configs.all_archs()) == ARCH_IDS
    assert len(ARCH_IDS) == 11
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "JAG_SHAPES"):
        assert getattr(TShapes, name) == getattr(RShapes, name), name
    for aid in ARCH_IDS:
        spec, rspec = configs.get(aid), RReg.get(aid)
        assert (spec.id, spec.family, spec.notes) == (rspec.id, rspec.family,
                                                      rspec.notes)
        assert spec.shapes == rspec.shapes
    jag = configs.get("jag").make_config()
    rjag = RReg.get("jag").make_config()
    for f in dataclasses.fields(rjag):
        assert getattr(jag, f.name) == getattr(rjag, f.name), f.name
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("jag-billion")


@pytest.fixture(scope="module")
def one_device_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), **mesh_kwargs(2))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_accounting_equals_the_reference(arch, one_device_mesh):
    """n_params, model_flops and flops_scale of every shape of ``arch``,
    and which cells are analytic only (the reference's ``build_1b``; the
    port's JAG serve step too, which reads its early stop on the host)."""
    tmesh = TMesh.Mesh(("data", "model"), (1, 1))
    for shape in RReg.get(arch).shapes:
        want = RReg.make_cell(arch, shape, one_device_mesh)
        got = configs.make_cell(arch, shape, tmesh)
        assert got["n_params"] == want["n_params"], (arch, shape)
        assert got["model_flops"] == want["model_flops"], (arch, shape)
        assert got["flops_scale"] == want.get("flops_scale", 1.0), shape
        if want.get("analytic_only"):
            assert got["analytic_only"], shape
        assert got["analytic_only"] == (arch == "jag"), shape
        assert all(t.device.type == "meta" for t in _tensors(got["args"]))
        assert len(got["specs"]) == len(got["args"])


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _at(tree, name):
    """The leaf of a reference tree at a port parameter name."""
    node = tree
    for key in name.split("."):
        node = node[int(key)] if isinstance(node, (list, tuple)) else \
            node[key]
    return node


def _reference_specs(family, cfg):
    """(spec tree, shape tree) of the reference's parameters at cfg."""
    key = jax.random.PRNGKey(0)
    if family == "lm":
        shapes, specs = RReg._lm_param_specs(cfg)
    elif family == "gnn":
        shapes = jax.eval_shape(lambda k: RG.init_params(cfg, k)[0], key)
        specs = RG.init_params(cfg, key)[1]
    else:
        shapes = jax.eval_shape(lambda k: RR.init_params(cfg, k)[0], key)
        specs = RR.init_params(dataclasses.replace(
            cfg, total_vocab=max(cfg.n_sparse * 8, 512), field_vocabs=()),
            key)[1]
    return specs, shapes


def _port_specs(family, cfg):
    if family == "lm":
        return TT.param_specs(cfg), TT.LM(cfg, torch.device("meta"))
    if family == "gnn":
        return TG.param_specs(cfg), TG.GCN(cfg, torch.device("meta"))
    return TR.param_specs(cfg), TR.Recsys(cfg, torch.device("meta"))


def _configs_of(arch):
    """The published config(s) of ``arch`` in both packages (the GCN's at
    each GNN shape's widths)."""
    spec, rspec = configs.get(arch), RReg.get(arch)
    if spec.family == "gnn":
        return [(spec.make_config(s), rspec.make_config(s))
                for s in spec.shapes]
    return [(spec.make_config(), rspec.make_config())]


@pytest.mark.parametrize("overrides", [False, True],
                         ids=["default", "overrides"])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "jag"])
def test_resolve_spec_equals_the_reference(arch, overrides):
    family = configs.get(arch).family
    for tcfg, rcfg in _configs_of(arch):
        rspecs, rshapes = _reference_specs(family, rcfg)
        tspecs, module = _port_specs(family, tcfg)
        named = dict(module.named_parameters())
        assert set(tspecs) == set(named)
        for mname, mesh in MESHES.items():
            ov = OVERRIDES[family] if overrides else None
            trules = TSh.make_rules(mesh, ov)
            rrules = RSh.make_rules(mesh, ov)
            assert trules.table == rrules.table
            for name, axes in tspecs.items():
                stacked = family == "lm" and name.startswith("layers.")
                ref_name = (f"layers.{name.split('.', 2)[2]}" if stacked
                            else name)
                raxes = _at(rspecs, ref_name)
                rshape = tuple(_at(rshapes, ref_name).shape)
                want = tuple(RSh.resolve_spec(raxes, rshape, rrules))
                if stacked:                 # [L, ...] under "layers"
                    assert raxes[0] == "layers" and want[0] is None
                    raxes, rshape, want = raxes[1:], rshape[1:], want[1:]
                assert tuple(axes) == tuple(raxes), name
                assert tuple(named[name].shape) == rshape, name
                got = TSh.resolve_spec(axes, named[name].shape, trules)
                assert got == want, (arch, mname, name, got, want)


def test_opt_specs_mirror_the_parameters():
    cfg = configs.get("qwen3-1.7b").make_config()
    ps = TT.param_specs(cfg)
    st = TOpt.opt_specs(ps)
    assert st.step == () and st.m == ps and st.v == ps
    rst = ROpt.opt_specs({"w": ("embed", "mlp")})
    assert (rst.step, rst.m, rst.v) == ((), {"w": ("embed", "mlp")},
                                        {"w": ("embed", "mlp")})
    cell = configs.make_cell("qwen3-1.7b", "train_4k", MESHES["single"])
    p_spec, o_spec, b_spec = cell["specs"]
    assert o_spec.step == () and o_spec.m == p_spec == o_spec.v
    assert cell["updates"] == (0, 1)
    assert b_spec == {"tokens": ("data", None)}
    # the divisibility guard: long_500k decodes one lane, replicated
    dec = configs.make_cell("qwen3-1.7b", "long_500k", MESHES["multi"])
    assert dec["specs"][2] == (None,)


def test_shard_shape_and_the_rules_context():
    mesh = MESHES["multi"]
    rules = TSh.make_rules(mesh)
    spec = TSh.resolve_spec(("embed", "mlp"), (2048, 6144), rules)
    assert spec == (("pod", "data"), "model")
    assert TSh.shard_shape((2048, 6144), spec, mesh) == (64, 384)
    # an axis taken by an earlier dim is dropped; a dim that does not
    # divide is replicated
    assert TSh.resolve_spec(("mlp", "heads"), (32, 32), rules) == ("model",
                                                                  None)
    assert TSh.resolve_spec(("heads",), (40,), rules) == (None,)
    x = torch.zeros(4, 6)
    assert TSh.logical_constraint(x, ("nope", None)) is x    # no rules
    with TSh.use_rules(rules) as r:
        assert TSh.current_rules() is r
        assert TSh.logical_constraint(x, ("batch", "act_embed")) is x
        with pytest.raises(KeyError, match="no rule"):
            TSh.logical_constraint(x, ("nope", None))
    assert TSh.current_rules() is None
    assert TMesh.HW["hbm_bytes"] == 80e9
    assert MESHES["single"].shape == {"data": 16, "model": 16}
    assert MESHES["multi"].size == 512 and MESHES["multi"].devices is None
    local = TMesh.make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1}
    assert np.prod(local.sizes) == len(local.devices)
