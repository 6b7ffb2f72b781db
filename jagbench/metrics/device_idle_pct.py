"""device_idle_pct: 100 minus the union of device events over the host's
wall clock, across the profiled batches."""
from jagbench.readers import device_idle_pct as read  # noqa: F401
