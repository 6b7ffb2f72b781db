"""qps: queries of every batch completed in the window over the window's
wall time."""
from jagbench.readers import qps as read  # noqa: F401
