"""Architecture configs (``--arch <id>``; counterpart of ``repro.configs``).
All from public literature.

Each module holds ``CONFIG`` (the published widths), ``REDUCED`` (the
smoke-test size) and its ``SPEC``, copied from the reference without its
XLA lowering knobs. ``get(arch_id)`` returns the ``ArchSpec``:
``make_config(shape)`` and ``make_reduced()`` give the configs, and
``make_cell`` builds an (arch x shape x mesh) cell for the dry run and the
perf harness (``registry.py``).
"""
from .registry import ArchSpec, all_archs, get, make_cell

__all__ = ["ArchSpec", "all_archs", "get", "make_cell"]
