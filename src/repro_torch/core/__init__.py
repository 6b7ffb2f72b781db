"""JAG core on PyTorch: filters, distances, beam search, build, the exact
scan and the index (counterparts of ``repro.core``)."""
from .filters import (AttrTable, FilterBatch, LABEL, RANGE, SUBSET, BOOLEAN,
                      label_table, range_table, subset_table, boolean_table,
                      label_filters, range_filters, subset_filters,
                      boolean_filters, matches, matches_all, selectivity,
                      pack_bits, unpack_bits,
                      And, Boolean, FilterExpr, Label, Leaf, Not, Or, Range,
                      Subset, as_filter, describe, filter_batch, joint_table,
                      matches_counted, matches_rows, n_leaves)
from .distances import dist_a, dist_f, capped, sq_norms
from .beam_search import greedy_search, SearchResult
from .build import BuildConfig, build_graph, medoid
from .prune import joint_robust_prune
from .jag import JAGConfig, JAGIndex
