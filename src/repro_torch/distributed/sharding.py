"""Logical-axis sharding rules and row-wise shard placement (counterpart
of ``repro.distributed.sharding``).

The reference's sharded index has one controller: a ``("data",)`` mesh over
the local devices, one ``shard_map`` program over every shard. Its
counterpart here is one process over a list of devices: a "mesh" is a
sequence of S ``torch.device``s, and shard s lives on ``mesh[s]``. A device
may repeat: ``[torch.device("cpu")] * 8`` plays the part of the
reference's ``--xla_force_host_platform_device_count=8``, and
``[cuda:0] * 4`` puts four shards on one card.

The logical-axis rules (``Rules``, ``make_rules``, ``resolve_spec``,
``tree_shardings``, ``logical_constraint``) are the reference's table:
models name each tensor dim by a logical axis ("embed", "mlp",
"experts", "batch", ...) and a rule set binds those names to the axes of a
mesh (``launch.mesh.Mesh``, or anything with ``axis_names`` and a
``shape`` mapping). Resolution is divisibility-aware: a dim that the bound
axes' product does not divide is replicated, and an axis that an earlier
dim of the same tensor took is dropped. A resolved spec is a tuple with one
binding per dim: ``None``, an axis name or a tuple of names.
``shard_shape`` gives one card's slice of a tensor under such a spec. The
port runs one eager process, so the rules serve the accounting (the dry
run's per-card bytes, ``launch/dryrun.py``) and there is no compiler to
hint: ``logical_constraint`` checks its axes and returns its input.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """A mesh (``axis_names`` and a ``shape`` mapping of axis sizes) and
    the table binding each logical axis name to mesh axes."""
    mesh: object
    table: Dict[str, MeshAxes]

    def axis_size(self, binding: MeshAxes) -> int:
        if binding is None:
            return 1
        names = (binding,) if isinstance(binding, str) else binding
        size = 1
        for n in names:
            size *= self.mesh.shape[n]
        return size


def make_rules(mesh, overrides: Optional[Dict[str, MeshAxes]] = None
               ) -> Rules:
    """The default binding for the production meshes, the reference's
    table: data parallelism over ("pod", "data"), tensor parallelism over
    "model", FSDP of the LM weights' embed dim over the data axes."""
    axes = set(mesh.axis_names)
    dp: MeshAxes = tuple(a for a in ("pod", "data") if a in axes) or None
    tp: MeshAxes = "model" if "model" in axes else None
    fsdp = dp
    table: Dict[str, MeshAxes] = {
        # activations ("seq" -> model = sequence parallelism; decode's T=1
        # falls back to replicated via the divisibility guard)
        "batch": dp, "seq": tp, "act_embed": None,
        "cache_batch": dp if dp else None, "cache_seq": tp,
        "queries": dp, "db_shard": "data" if "data" in axes else None,
        # LM weights: fsdp on embed dim, tensor on mlp/heads/vocab/experts
        "embed": fsdp, "mlp": tp, "vocab": tp,
        "heads": tp, "kv_heads": tp, "head_dim": None,
        "experts": tp, "expert_cap": fsdp, "expert_mlp": None,
        "layers": None, "norm": None,
        # gnn / recsys
        "nodes": dp, "edges": dp, "feat": None,
        "table_rows": (tuple(a for a in ("data", "model") if a in axes)
                       or None),
        "table_dim": None, "fields": None, "mlp_in": fsdp,
        "mlp_hidden": tp, "candidates": tp,
    }
    if overrides:
        table.update(overrides)
    return Rules(mesh, table)


_local = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Make ``rules`` the ambient rule set of this thread while inside."""
    prev = current_rules()
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 rules: Rules) -> Spec:
    """Logical axes (one name or ``None`` per dim) -> one binding per dim.

    Safety valves: a binding is dropped (replicated) if the dim is not
    divisible by the bound mesh-axis product, or if any of its mesh axes
    was already consumed by an earlier dim of the same tensor. A name the
    table lacks is replicated, as in the reference."""
    parts = []
    used: set = set()
    for dim, name in zip(shape, axes):
        binding = rules.table.get(name) if name else None
        if binding is not None:
            names = (binding,) if isinstance(binding, str) else tuple(binding)
            free = tuple(n for n in names if n not in used)
            binding = (free[0] if len(free) == 1 else free) if free else None
        if binding is not None and dim % rules.axis_size(binding) != 0:
            binding = None  # fall back to replication for this dim
        if binding is not None:
            used.update((binding,) if isinstance(binding, str) else binding)
        parts.append(binding)
    return tuple(parts)


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_shardings(spec_tree, shape_tree, rules: Rules):
    """Parallel trees (nested dicts) of logical-axes tuples and of shapes
    (tensors or tuples) -> the same tree of resolved specs."""
    if isinstance(spec_tree, Mapping):
        return {k: tree_shardings(v, shape_tree[k], rules)
                for k, v in spec_tree.items()}
    return resolve_spec(spec_tree, _shape_of(shape_tree), rules)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One card's slice of a tensor of ``shape`` laid out by ``spec`` (a
    resolved spec) on ``mesh``: each dim divided by its axes' sizes."""
    out = []
    for i, dim in enumerate(shape):
        binding = spec[i] if i < len(spec) else None
        names = (() if binding is None else (binding,)
                 if isinstance(binding, str) else binding)
        size = 1
        for n in names:
            size *= mesh.shape[n]
        if dim % size:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide by "
                             f"{size} ({binding})")
        out.append(dim // size)
    return tuple(out)


def logical_constraint(x: torch.Tensor, axes: Sequence[Optional[str]]
                       ) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` through the ambient
    rule set. One eager process has no compiler to hint, so this resolves
    the spec against the rules (raising on a logical axis the table does
    not know) and returns ``x`` unchanged; without ambient rules it is a
    no-op."""
    rules = current_rules()
    if rules is None:
        return x
    unknown = [a for a in axes if a is not None and a not in rules.table]
    if unknown:
        raise KeyError(f"logical axes {unknown} have no rule")
    resolve_spec(axes, x.shape, rules)
    return x


def as_mesh(mesh: Sequence) -> Tuple[torch.device, ...]:
    """A device list (``torch.device``s or names) as a tuple of resolved
    devices; raises if it is empty or names CUDA where none is visible."""
    devs = tuple(resolve_device(d) for d in mesh)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def serve_mesh(n_shards: int) -> Tuple[torch.device, ...]:
    """The first ``n_shards`` visible CUDA devices, shard s on device s.

    Raises when fewer are visible; to place several shards on one device,
    or on the CPU, pass the device list as ``mesh=`` instead (for example
    ``[torch.device("cuda:0")] * 4``).
    """
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_shards > n_dev:
        raise ValueError(
            f"n_shards={n_shards} > {n_dev} visible devices: pass mesh= "
            f"explicitly (a list of {n_shards} devices, which may repeat), "
            f"or lower n_shards")
    return as_mesh([f"cuda:{i}" for i in range(n_shards)])


def put_db_sharded(tree, mesh: Sequence[torch.device]):
    """Place per-shard tensors on the mesh: every leaf of ``tree`` (nested
    dicts) is a sequence of S tensors, or a stacked ``[S, ...]`` tensor,
    and becomes a tuple whose element s is on ``mesh[s]``.

    Each shard's tensor moves on its own (a no-op where it is already on
    its device): no shard receives a copy of the union.
    """
    if isinstance(tree, dict):
        return {k: put_db_sharded(v, mesh) for k, v in tree.items()}
    if len(tree) != len(mesh):
        raise ValueError(f"{len(tree)} shards for a mesh of {len(mesh)} "
                         f"devices")
    return tuple(t.to(dev) for t, dev in zip(tree, mesh))
