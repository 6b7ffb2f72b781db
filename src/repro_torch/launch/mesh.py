"""Meshes for the cells' accounting and the card's constants (counterpart of
``repro.launch.mesh``).

A ``Mesh`` is a record: its axis names, their sizes and, where the cards
are on hand, their devices. The production meshes are the reference's
shapes, a pod of (16, 16) cards over ("data", "model") and two pods of
(2, 16, 16) with "pod" in front; here their cards are H100s that one
machine does not have, so ``devices`` is ``None`` and the mesh serves the
rules' accounting (``distributed.sharding``, ``launch/dryrun.py``).
``make_local_mesh`` lays the visible cards out as (n / model, model).

``HW`` is ``launch.roofline.HW`` (one H100 SXM) with the card's memory,
``hbm_bytes``: the data sheet's 80 GB; ``card_hbm_bytes`` reads the
card's ``total_memory`` where one is present. The reference's TPU v5e
constants have no counterpart here, and neither have its ``mesh_kwargs``
and ``set_mesh``, which bridge JAX versions.

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .roofline import HW as _CARD

HW = dict(_CARD, hbm_bytes=80e9)   # H100 SXM data sheet: 80 GB of HBM3


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes and the devices (row-major over the axes),
    or ``None`` for a mesh kept for accounting only."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model"); no devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(model: int = 1, device: str = "cuda") -> Mesh:
    """The visible cards as a (n / model, model) mesh over ("data",
    "model"); ``device="cpu"`` gives a one-device CPU mesh. Raises if no
    card is visible or ``model`` does not divide their number."""
    if device == "cpu":
        devs = (torch.device("cpu"),)
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_local_mesh: torch sees no GPU; pass "
                               "device='cpu'")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if len(devs) % model:
        raise ValueError(f"model={model} does not divide {len(devs)} "
                         f"devices")
    return Mesh(("data", "model"), (len(devs) // model, model), devs)


def card_hbm_bytes() -> Tuple[float, str]:
    """(bytes of memory a card holds, where the figure comes from): the
    current card's ``total_memory`` where torch sees one, else the data
    sheet's 80 GB."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return float(props.total_memory), f"total_memory of {props.name}"
    return HW["hbm_bytes"], "H100 SXM data sheet (80 GB)"
