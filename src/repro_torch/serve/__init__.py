"""Serving on PyTorch: layout, engine, planner, dispatch and executor
(counterparts of ``repro.serve``)."""
