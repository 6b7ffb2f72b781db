"""JAG on PyTorch and CUDA: the port of ``repro`` (JAX/Pallas on a TPU) to
an NVIDIA H100.

The subpackages mirror ``repro``'s, so each module's reference is the file
of the same name there: ``core/`` (filters, distances, beam search, build,
the exact scan, the index), ``serve/`` (layout, engine, planner, dispatch,
executor), ``stream/`` (the streaming index), ``kernels/`` (wrappers of
the hand-written CUDA kernels in ``csrc/`` and their plain PyTorch
versions), ``models/`` and ``train/`` (the LMs, AdamW and the train
step), ``checkpoint/`` and ``data/``.

This package imports torch and numpy, never jax and never ``repro``. Entry
points take ``device=`` and default to ``"cuda"``; resolving a CUDA device
turns TF32 off for float32 products (see ``repro_torch.device``).

    import repro_torch as rt
    idx = rt.JAGIndex.build(xb, rt.subset_table(bits, 30), rt.JAGConfig())
    res = idx.search_auto(q, rt.Subset(fbits), k=10, layout="fused")
"""
from .core.beam_search import SearchResult
from .core.filters import (And, AttrTable, Boolean, FilterBatch, FilterExpr,
                           Label, Not, Or, Range, Subset, as_filter,
                           boolean_filters, boolean_table, describe,
                           filter_batch, joint_table, label_filters,
                           label_table, matches, n_leaves, range_filters,
                           range_table, selectivity, subset_filters,
                           subset_table)
from .core.ground_truth import GroundTruth, exact_filtered_knn
from .core.jag import JAGConfig, JAGIndex

__all__ = ["And", "AttrTable", "Boolean", "FilterBatch", "FilterExpr",
           "GroundTruth", "JAGConfig", "JAGIndex", "Label", "Not", "Or",
           "Range", "SearchResult", "Subset", "as_filter", "boolean_filters",
           "boolean_table", "describe", "exact_filtered_knn",
           "filter_batch", "joint_table", "label_filters", "label_table",
           "matches", "n_leaves", "range_filters", "range_table",
           "selectivity", "subset_filters", "subset_table"]
