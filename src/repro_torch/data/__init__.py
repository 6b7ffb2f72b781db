"""Synthetic filtered-ANN datasets, the LM token stream, recsys click logs,
and graphs with their fanout sampler (counterpart of ``repro.data``)."""
