"""batch_p90_ms: the 90th percentile, by nearest rank, of every batch's
latency in the window."""
from jagbench.readers import batch_p90_ms as read  # noqa: F401
