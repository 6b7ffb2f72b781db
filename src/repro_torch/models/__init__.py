"""Models on PyTorch (counterparts of ``repro.models``): the decoder LM
(dense and MoE) in ``transformer.py``, the recsys models in
``recsys.py`` and the GCN in ``gnn.py``, built from ``layers.py``."""
