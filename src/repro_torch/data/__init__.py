"""Synthetic filtered-ANN datasets (counterpart of ``repro.data``)."""
