"""Models on PyTorch (counterparts of ``repro.models``): the dense decoder
LM in ``transformer.py``, built from ``layers.py``."""
