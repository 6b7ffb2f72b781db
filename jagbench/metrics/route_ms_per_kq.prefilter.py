"""route_ms_per_kq.prefilter: ms per 1000 queries that the planner sent to the
prefilter route, each group timed once finished on the device."""
from jagbench.readers import route_ms_per_kq


def read(run):
    return route_ms_per_kq(run, "prefilter")
