"""Row-wise shard placement for sharded serving (the serving part of
``repro.distributed.sharding``).

The reference's sharded index has one controller: a ``("data",)`` mesh over
the local devices, one ``shard_map`` program over every shard. Its
counterpart here is one process over a list of devices: a "mesh" is a
sequence of S ``torch.device``s, and shard s lives on ``mesh[s]``. A device
may repeat: ``[torch.device("cpu")] * 8`` plays the part of the
reference's ``--xla_force_host_platform_device_count=8``, and
``[cuda:0] * 4`` puts four shards on one card.

The logical-axis rules of the reference's LM sharding (``Rules``,
``make_rules``, ``resolve_spec``, ``tree_shardings``,
``logical_constraint``) are not here: they wait for the LM-sharding work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..device import resolve_device


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
