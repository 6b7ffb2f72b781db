"""plan_dispatch_ms: a batch's latency minus its groups' ``on_group``
times, averaged over the traced window's batches."""
from jagbench.readers import plan_dispatch_ms as read  # noqa: F401
