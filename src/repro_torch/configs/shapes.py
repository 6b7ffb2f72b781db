"""Input shapes per model family (the LM, GNN and recsys rows of
``repro.configs.shapes``; the JAG rows come with the cells)."""

LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,    batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,   batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,   batch=128),
    "long_500k":   dict(kind="decode",  seq=524288,  batch=1),
}

GNN_SHAPES = {
    # cora full batch
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    # reddit-scale sampled training (232965 nodes / 114.6M edges / 602 feats)
    "minibatch_lg":  dict(kind="sampled", n_nodes=232965,
                          n_edges=114_615_892, batch_nodes=1024,
                          fanout=(15, 10), d_feat=602, n_classes=41),
    # ogbn-products full batch
    "ogb_products":  dict(kind="full", n_nodes=2_449_029,
                          n_edges=61_859_140, d_feat=100, n_classes=47),
    # batched small graphs (graph classification)
    "molecule":      dict(kind="batched", n_nodes=30, n_edges=64,
                          batch=128, d_feat=32, n_classes=10),
}

RECSYS_SHAPES = {
    "train_batch":    dict(kind="train",     batch=65536),
    "serve_p99":      dict(kind="serve",     batch=512),
    "serve_bulk":     dict(kind="serve",     batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}
