"""gcn-cora [arXiv:1609.02907]: 2-layer GCN, d_hidden=16, mean/sym-norm
aggregation. Per-shape d_feat/n_classes follow the assigned shape set
(cora / reddit-sampled / ogbn-products / molecules)."""
from ..models.gnn import GCNConfig
from .shapes import GNN_SHAPES


def make_config(shape=None) -> GCNConfig:
    """The config at ``GNN_SHAPES[shape]``'s feature width and classes
    (cora's ``full_graph_sm`` by default)."""
    shp = GNN_SHAPES[shape or "full_graph_sm"]
    return GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16,
                     norm="sym",
                     d_feat=shp["d_feat"], n_classes=shp["n_classes"])


CONFIG = make_config()

REDUCED = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16,
                    d_feat=32, n_classes=5)
