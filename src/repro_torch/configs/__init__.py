"""Model configurations of the port (counterparts of ``repro.configs``).

Ported: the LMs (the dense qwen3, minicpm and gemma, and the llama4 scout
and maverick: MoE with the shared expert, chunked and NoPE attention),
the recsys models (fm, deepfm, wide-deep, din) and the GCN (gcn-cora,
whose ``make_config(shape)`` follows ``GNN_SHAPES``). Each module holds
``CONFIG`` (the published widths) and ``REDUCED`` (the smoke-test size),
copied from the reference without its XLA lowering knobs.
``get(arch_id)`` returns the module; the reference's ``ArchSpec``
registry (and jag-billion) comes with the cells.
"""
from __future__ import annotations

import importlib
from types import ModuleType

_PORTED = {"qwen3-1.7b": "qwen3_1_7b", "minicpm-2b": "minicpm_2b",
           "gemma-7b": "gemma_7b",
           "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
           "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
           "fm": "fm", "deepfm": "deepfm", "wide-deep": "wide_deep",
           "din": "din", "gcn-cora": "gcn_cora"}


def get(arch_id: str) -> ModuleType:
    """The config module of ``arch_id`` (``CONFIG``, ``REDUCED``)."""
    if arch_id not in _PORTED:
        raise KeyError(f"{arch_id!r} is not ported; ported: "
                       f"{sorted(_PORTED)}")
    return importlib.import_module(f"{__name__}.{_PORTED[arch_id]}")
