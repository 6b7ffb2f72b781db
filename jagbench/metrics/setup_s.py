"""setup_s: process start to the window's start: imports, data, the
index build, the kernels' load (and, in a fresh checkout, their build),
the warm-up batches."""


def read(run):
    return run.setup_s
