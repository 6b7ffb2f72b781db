"""Model configurations of the port (counterparts of ``repro.configs``).

The dense LM configs are ported: each module holds ``CONFIG`` (the
published widths) and ``REDUCED`` (the smoke-test size), copied from the
reference without its XLA lowering knobs. ``get(arch_id)`` returns the
module. The llama4 configs (MoE, chunked attention) come with a later
slice.
"""
from __future__ import annotations

import importlib
from types import ModuleType

_PORTED = {"qwen3-1.7b": "qwen3_1_7b", "minicpm-2b": "minicpm_2b",
           "gemma-7b": "gemma_7b"}


def get(arch_id: str) -> ModuleType:
    """The config module of ``arch_id`` (``CONFIG``, ``REDUCED``)."""
    if arch_id not in _PORTED:
        raise KeyError(f"{arch_id!r} is not ported; ported: "
                       f"{sorted(_PORTED)}")
    return importlib.import_module(f"{__name__}.{_PORTED[arch_id]}")
