"""Synthetic filtered-ANN datasets and the LM token stream (counterpart of
``repro.data``)."""
