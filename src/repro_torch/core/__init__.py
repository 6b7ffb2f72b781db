"""JAG core on PyTorch: filters, distances, beam search, build, the exact
scan and the index (counterparts of ``repro.core``)."""
