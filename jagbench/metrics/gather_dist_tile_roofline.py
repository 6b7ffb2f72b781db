"""gather_dist_tile_roofline: the bound of the scan work of the profiled batches'
scanned queries (frozen ``kernel_work``, published peaks) over the device
time of ``gather_dist_tile`` in their trace, in percent."""
from jagbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "gather_dist_tile")
