"""jagbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once::

    python3 jagbench/run.py --workload subset-mixed --seed 7 --seconds 51 --trace 0

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the repo root:
a configuration (a deployment: data scale, filter kind, index settings,
``configs/<name>.json``) under a traffic mix (batch size, pool, filter
draw, ``traffic/<name>.json``). The filter kind named by a configuration
has a module of its own (``kinds/<kind>.py``: the frozen data generator,
the program's tables and filters, the reference's predicate), and every
metric has a reader of its own (``metrics/<name>.py``). The harness finds
all of them by name, so a later change adds a configuration, a cell or a
metric by adding files and ``BENCHMARK.json`` entries.

The yardstick lives here and imports nothing of the program: the data
generators, the reference, the comparison that decides ``correct``, the
device-trace arithmetic, the work formulas and the table of peaks. From
the program (``src/repro_torch``) the harness takes only the system under
test: ``JAGIndex.build`` and ``JAGIndex.search_auto``, the attribute
tables and filters they take, and the kernels' build cache.
"""
