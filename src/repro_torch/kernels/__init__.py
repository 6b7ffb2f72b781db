"""Hand-written CUDA kernels (``csrc/``): ``ops`` dispatches by device,
``ref`` holds the plain PyTorch versions, ``_build`` compiles with nvcc,
``autograd`` gives training attention a gradient (the kernel forward, the
plain version's backward)."""
from . import ops, ref
